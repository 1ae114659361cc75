"""Flow-estimator pretraining (port of `deep_sfm_revisited_tpu/train/flow_trainer.py`).

The reference references a flow-pretraining path (`cfg.TRAIN_FLOW`,
`models/SFMnet.py:98-100`) whose `flow_training` module is missing
upstream; the JAX package built it, and this is its port: supervised flow
training over the flow benchmarks (`data/flow_datasets.py`) with DICL's
multiscale loss, AdamW under optax's linear one-cycle schedule after
global-norm clipping, per-epoch checkpoints with the best by validation EPE,
and the EPE / Fl-all validation (`train/flow_eval.py`). The checkpoint holds
the flow network alone, so `--pretrained-flow` restores it into the SfM
composite (`train/checkpoint.py::restore_subtree`).

DICL, PWC-DC and RAFT are the ported estimators (DICL with its multiscale
loss; PWC-DC with RAFT's sequence loss over its five levels and RAFT with
it over its `raft_iters_train` iterations, gamma 0.8 and max_flow 400 as in
JAX).
Mixed precision is the model's bf16 autocast (`train.mixed_prec`);
parameters and the optimizer stay float32.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deep_sfm_revisited_tpu_torch.config import FlowConfig, SfMConfig
from deep_sfm_revisited_tpu_torch.train.losses import (flow_epe, flow_sequence_loss,
                                                        multiscale_flow_loss)

# per-level weights of the DICL multiscale loss (cfgs/kitti.yml
# MultiScale_W) in the REFERENCE'S order: fine -> coarse, (refined, raw) per
# level (DICL_shallow.py:660-663). The all_iters stack is coarse -> fine with
# (raw, refined) per level, the exact reverse: slice to the stack's length,
# then reverse (JAX `flow_trainer.py:31-46`).
DICL_LEVEL_WEIGHTS = (1.0, 0.8, 0.75, 0.6, 0.5, 0.4, 0.5, 0.4, 0.5, 0.4)
# per-level |gt| gates (cfgs/kitti.yml VALID_RANGE, USE_VALID_RANGE=True), in
# the same order: a pixel beyond its level's range is zeroed but counted
DICL_VALID_RANGE = ((372, 372), (372, 372), (360, 360), (360, 360),
                    (336, 336), (336, 336), (288, 288), (288, 288),
                    (192, 192), (192, 192))


def flow_loss(cfg: FlowConfig, preds: torch.Tensor, flow_gt: torch.Tensor,
              valid: Optional[torch.Tensor] = None, gamma: float = 0.8) -> torch.Tensor:
    """The supervised flow loss of a prediction stack (L, B, H, W, 2): DICL's
    multiscale loss with its level weights and valid ranges, else RAFT's
    sequence loss (JAX `make_flow_train_step`'s `loss_fn`)."""
    if cfg.estimator == "DICL":
        L = preds.shape[0]
        return multiscale_flow_loss(list(preds), flow_gt, DICL_LEVEL_WEIGHTS[:L][::-1], valid,
                                    valid_range=DICL_VALID_RANGE[:L][::-1])
    return flow_sequence_loss(preds, flow_gt, valid, gamma=gamma)


def build_flow_model(cfg: FlowConfig, seed: int = 0) -> torch.nn.Module:
    """The flow network, DICL, PWC-DC or RAFT, with random weights from
    `seed` (the composite's init rule, `models/sfmnet.py::init_weights`)."""
    from deep_sfm_revisited_tpu_torch.models.sfmnet import FLOW_NETS, init_weights

    if cfg.estimator not in FLOW_NETS:
        raise NotImplementedError(f"flow pretraining of {cfg.estimator} is not ported")
    model = FLOW_NETS[cfg.estimator](cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def linear_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3) -> Callable[[int], float]:
    """optax's `linear_onecycle_schedule` (its pct_final 0.85, div_factor 25
    and final_div_factor 1e4): linear from peak / 25 up to the peak at
    int(pct_start T), down to peak / 25 at int(0.85 T), then to that over
    1e4 at T, constant after. optax interpolates inside every interval of
    its boundaries, and an interval of length 0 (int(pct_start T) = 0, i.e.
    T < 20 at pct_start 0.05) divides by zero and makes every step's rate
    NaN; here an empty interval holds no step and is skipped, so every rate
    is finite and equals optax's wherever optax's is."""
    if transition_steps <= 0:
        raise ValueError("a linear one-cycle schedule needs transition_steps > 0")
    init = peak_value / 25.0
    bounds_scales = sorted({int(pct_start * transition_steps): 25.0,
                            int(0.85 * transition_steps): 1.0 / 25.0,
                            transition_steps: 1.0 / 1e4}.items())
    bounds = [0] + [b for b, _ in bounds_scales]
    values = list(np.cumprod([init] + [s for _, s in bounds_scales]))

    def schedule(count: int) -> float:
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return float(values[i] + pct * (values[i + 1] - values[i]))
        return float(values[-1])

    return schedule


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's `clip_by_global_norm` on the gradients of `params`, in place:
    with g = the global L2 norm over all of them, each becomes (t / g) max_norm
    unless g < max_norm (torch's `clip_grad_norm_` scales by max / (g + 1e-6)
    whenever g exceeds max). Returns g."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm          # decided on the device: no synchronisation
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class FlowTrainer:
    """The flow network, AdamW and the step count; `train_step` is one
    optimization step (JAX `make_flow_train_step` with `create_flow_state`'s
    optimizer): `optax.chain(clip_by_global_norm(1.0), adamw(linear_onecycle
    (total_steps, lr, pct_start=0.05), weight_decay))`. optax's AdamW
    applies -lr (adam + wd p) to every parameter, which is torch's AdamW with
    one group, eps 1e-8, decay on every parameter, and the rate of step k set
    to the schedule's value at k; a parameter without a gradient gets a zero
    one, as optax's update sees it."""

    def __init__(self, model: torch.nn.Module, cfg: SfMConfig, total_steps: int,
                 weight_decay: float = 1e-5):
        self.model = model
        self.cfg = cfg
        self.schedule = linear_onecycle_schedule(max(total_steps, 1), cfg.train.lr,
                                                 pct_start=0.05)
        self.optimizer = torch.optim.AdamW(model.parameters(), lr=self.schedule(0),
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)
        self.step = 0

    def _autocast(self, device: torch.device):
        return torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                              enabled=self.cfg.train.mixed_prec)

    def loss_and_metrics(self, batch: Dict[str, torch.Tensor]):
        """The train-mode forward and loss of one batch dict(ref, target,
        flow_gt[, flow_valid]) -> (loss, epe)."""
        pair = torch.cat([batch["ref"], batch["target"]], dim=-1)
        with self._autocast(pair.device):
            preds, _ = self.model(pair, all_iters=True)     # float32 flows
        valid = batch.get("flow_valid")
        gt = batch["flow_gt"]
        loss = flow_loss(self.cfg.flow, preds, gt, valid)
        return loss, flow_epe(preds[-1], gt, valid)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Forward in train mode, backward, global-norm clipping, one AdamW
        update at the schedule's rate for this step. Returns {loss, epe} as
        detached 0-d tensors on the device."""
        self.model.train()
        loss, epe = self.loss_and_metrics(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_(params, 1.0)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach(), "epe": epe.detach()}

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def flow_fit(cfg: SfMConfig, train_loader, out_dir: str, val_dataset=None,
             device: str | torch.device = "cuda",
             eval_pad_multiple: int = 64) -> List[Dict[str, float]]:
    """The flow-pretraining run (JAX `flow_fit`): `train.epochs` epochs over
    `train_loader` (a BatchLoader of flow samples), the step's loss and EPE
    averaged over each `train.print_freq` window into the `flow_train`
    scalars, after each epoch the EPE / Fl-all validation on `val_dataset`
    (when given) and a checkpoint under `<out_dir>/ckpt`, the best by
    validation EPE (else by mean loss) copied to `model_best.pt`. Returns
    one record per epoch: {epoch, step, train_loss, train_epe[, epe,
    f1_all, n]}."""
    from deep_sfm_revisited_tpu_torch.train.checkpoint import save_checkpoint
    from deep_sfm_revisited_tpu_torch.train.evaluate import batch_to_device
    from deep_sfm_revisited_tpu_torch.utils.device import resolve_device
    from deep_sfm_revisited_tpu_torch.utils.logging import (AverageMeter, MetricLogger,
                                                            create_logger)

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    logger = create_logger(out_dir, "flow")
    mlog = MetricLogger(out_dir, "flow_train")
    t = cfg.train
    model = build_flow_model(cfg.flow, seed=t.seed).to(dev)
    trainer = FlowTrainer(model, cfg, total_steps=max(len(train_loader) * t.epochs, 1))
    best, history = np.inf, []
    try:
        for epoch in range(t.epochs):
            losses, epes = AverageMeter(), AverageMeter()
            nb = len(train_loader)
            window: Dict[str, List[float]] = {"epe": [], "loss": []}
            for i, host_batch in enumerate(train_loader):
                metrics = trainer.train_step(batch_to_device(host_batch, dev))
                bsz = host_batch["ref"].shape[0]
                for k in window:
                    window[k].append(float(metrics[k]))
                losses.update(window["loss"][-1], n=bsz)
                epes.update(window["epe"][-1], n=bsz)
                if (i + 1) % t.print_freq == 0 or i == nb - 1:
                    mlog.scalars({k: sum(v) / len(v) for k, v in window.items()},
                                 epoch * nb + i + 1)
                    window = {k: [] for k in window}
            record = {"epoch": epoch, "step": trainer.step, "train_loss": losses.avg,
                      "train_epe": epes.avg}
            metric = losses.avg
            if val_dataset is not None:
                from deep_sfm_revisited_tpu_torch.train.flow_eval import (evaluate_flow_dataset,
                                                                          make_flow_forward)

                res = evaluate_flow_dataset(make_flow_forward(model, cfg), val_dataset,
                                            pad_multiple=eval_pad_multiple)
                logger.info(f"epoch {epoch}: loss {losses.avg:.4f} epe {res['epe']:.4f} "
                            f"f1 {res['f1_all']:.2f}")
                record.update(res)
                metric = res["epe"]
            else:
                logger.info(f"epoch {epoch}: loss {losses.avg:.4f}")
            is_best = metric < best
            best = min(metric, best)
            save_checkpoint(os.path.join(out_dir, "ckpt"), trainer, epoch, is_best)
            history.append(record)
    finally:
        mlog.close()
    return history
