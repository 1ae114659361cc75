"""Host-side training loop (port of `deep_sfm_revisited_tpu/train/loop.py`,
`train_epoch` and `fit`, `:72-143,383-473`).

The reference's training program (`main()` `main.py:122`, `train_epoch`
`main.py:295`): epochs of training steps over the KITTI loader, per-step JSONL and
TensorBoard scalars, image panes every `train.image_freq` steps (one extra
eval forward, `main.py:429-447`), the Eigen-protocol `validate` at the end
of each epoch, a checkpoint per epoch with the best one copied
(`main.py:287-288`), the effective config dumped at the start, and a resume
from `start_epoch`. The JAX package's chained programs are a TPU dispatch
device; here the plain per-step loop does the same work.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deep_sfm_revisited_tpu_torch.config import SfMConfig, save_config
from deep_sfm_revisited_tpu_torch.train.checkpoint import save_checkpoint
from deep_sfm_revisited_tpu_torch.train.evaluate import batch_to_device, validate
from deep_sfm_revisited_tpu_torch.train.trainer import Trainer
from deep_sfm_revisited_tpu_torch.utils.logging import AverageMeter, MetricLogger, create_logger


def emit_images(metric_logger: MetricLogger, prefix: str, batch: Dict[str, torch.Tensor],
                flow: torch.Tensor, depth: torch.Tensor, step: int) -> None:
    """The reference's image panes: input, flow RGB, predicted and GT depth
    colormaps of the batch's first pair (JAX `loop.py::_emit_images`)."""
    from deep_sfm_revisited_tpu_torch.utils.viz import depth_to_colormap, flow_to_rgb

    def host(x):
        return x[0].detach().float().cpu().numpy()

    img = ((np.clip(host(batch["ref"]), -1.0, 1.0) * 0.5 + 0.5) * 255).astype(np.uint8)
    metric_logger.image(f"{prefix}/input", img, step)
    metric_logger.image(f"{prefix}/flow", flow_to_rgb(host(flow)), step)
    metric_logger.image(f"{prefix}/depth_pred", depth_to_colormap(host(depth)), step)
    if "depth_gt" in batch:
        metric_logger.image(f"{prefix}/depth_gt", depth_to_colormap(host(batch["depth_gt"])),
                            step)


def train_epoch(loader, trainer: Trainer, epoch: int, generator: torch.Generator,
                logger=None, metric_logger: Optional[MetricLogger] = None,
                print_freq: int = 20, image_freq: int = 0) -> float:
    """One epoch of `trainer.train_step` over `loader` (JAX `train_epoch`,
    plain form); returns the mean loss. Scalars go to `metric_logger` at
    each global step."""
    device = next(trainer.model.parameters()).device
    losses, batch_time = AverageMeter(), AverageMeter()
    end = time.time()
    for i, host_batch in enumerate(loader):
        batch = batch_to_device(host_batch, device)
        metrics = {k: float(v) for k, v in trainer.train_step(batch, generator).items()}
        losses.update(metrics["loss"], n=host_batch["ref"].shape[0])
        batch_time.update(time.time() - end)
        end = time.time()
        if metric_logger is not None:
            metric_logger.scalars(metrics, trainer.step)
            if image_freq > 0 and trainer.step % image_freq == 0:
                model = trainer.model.eval()
                with torch.no_grad():
                    out = model(batch["ref"], batch["target"], batch["intrinsics"],
                                pose_gt=batch.get("pose_gt"), pred_pose=batch.get("pred_pose"),
                                use_gt_pose=trainer.cfg.use_gt_pose,
                                generator=torch.Generator(device=device).manual_seed(
                                    trainer.step))
                model.train()
                emit_images(metric_logger, "train", batch, out["flow"], out["depth"],
                            trainer.step)
        if logger is not None and i % print_freq == 0:
            logger.info(f"Epoch: [{epoch}][{i}/{len(loader)}]\tTime {batch_time}\t"
                        f"Loss {losses}")
    return losses.avg


def fit(cfg: SfMConfig, train_loader, val_loader=None, out_dir: str = "output",
        device: str | torch.device = "cuda", restore_fn: Optional[Callable] = None,
        start_epoch: int = 0) -> List[Dict[str, float]]:
    """A training run (JAX `fit`): epochs `start_epoch` .. `train.epochs`-1,
    each followed by `validate` (when a loader is given) and a checkpoint
    under `<out_dir>/<tag>/ckpt`. `restore_fn(trainer)` applies the
    `--pretrained*` restores before the first step. Returns one record per
    epoch: {epoch, step, train_loss, and the validation metrics}."""
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet

    out = os.path.join(out_dir, cfg.tag)
    os.makedirs(out, exist_ok=True)
    logger = create_logger(out, cfg.tag)
    logger.info("effective config:\n" + save_config(cfg, os.path.join(out, "config.yaml")))
    mlog = MetricLogger(out, "train")
    mlog_val = MetricLogger(out, "test") if val_loader is not None else None

    dtype = torch.bfloat16 if cfg.train.mixed_prec else torch.float32
    model = SFMNet(cfg, dtype=dtype, device=device, seed=cfg.train.seed).train()
    trainer = Trainer(model, cfg, steps_per_epoch=len(train_loader))
    if restore_fn is not None:
        restore_fn(trainer)

    best, history = np.inf, []
    dev = model.device
    try:
        for epoch in range(start_epoch, cfg.train.epochs):
            # the loader draws its order from its seed and epoch, and the
            # noise and RANSAC draws from one generator per epoch, so a
            # resumed epoch sees what an uninterrupted run's epoch sees
            train_loader._epoch = epoch
            gen = torch.Generator(device=dev).manual_seed(cfg.train.seed + 1 + epoch)
            avg = train_epoch(train_loader, trainer, epoch, gen, logger, mlog,
                              cfg.train.print_freq, cfg.train.image_freq)
            record = {"epoch": epoch, "step": trainer.step, "train_loss": avg}
            metric = avg
            if val_loader is not None:
                model.eval()
                results = validate(val_loader, model, cfg,
                                   generator=torch.Generator(device=dev).manual_seed(0),
                                   logger=logger, metric_logger=mlog_val)
                model.train()
                mlog_val.scalars(results, epoch)
                record.update(results)
                metric = results["abs_rel"]
            is_best = metric < best
            best = min(metric, best)
            save_checkpoint(os.path.join(out, "ckpt"), trainer, epoch, is_best)
            history.append(record)
    finally:
        mlog.close()
        if mlog_val is not None:
            mlog_val.close()
    return history
