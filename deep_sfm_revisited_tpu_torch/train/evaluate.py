"""Eigen-protocol evaluation of SFMNet (port of the JAX package's eval step,
`train/trainer.py:443-507`, and of `train/loop.py::validate`, `:236-361`).

Per sample: the depth prediction, with the NORM_TARGET normalization undone
by the ground-truth translation scale, is scored by `evaluate_depth` at the
sample's raw (pre-pad) size; a batch's metrics are the `sample_valid`
-weighted mean over its samples, and `validate` averages batches weighted by
their valid-sample count (the reference's per-image AverageMeter,
`main.py:593-596`). The JAX package's `ChainedEval` fuses K batches into one
TPU dispatch; here each batch is one eager forward.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deep_sfm_revisited_tpu_torch.config import SfMConfig
from deep_sfm_revisited_tpu_torch.train.metrics import evaluate_depth
from deep_sfm_revisited_tpu_torch.utils.logging import AverageMeter


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch -> tensors on `device` (arrays only)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def eval_metrics(model, cfg: SfMConfig, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None):
    """One batch -> (metrics {name: 0-d tensor}, model outputs).

    The 9 depth metrics, plus `num_matches` and `uniform_fallback` on
    routes whose sampler reports confident-candidate counts (DICL's entropy
    sampler; PWC-DC has none)."""
    out = model(batch["ref"], batch["target"], batch["intrinsics"],
                pose_gt=batch.get("pose_gt"), pred_pose=batch.get("pred_pose"),
                use_gt_pose=cfg.use_gt_pose, generator=generator)
    depth = out["depth"].float()
    t = cfg.train
    if t.rescale_depth and batch.get("pose_gt") is not None:
        scale = torch.linalg.vector_norm(batch["pose_gt"][:, :3, 3].float(), dim=-1)
        depth = depth * (scale / t.norm_target)[:, None, None]
    gt, raw_hw = batch["depth_gt"].float(), batch.get("raw_hw")
    per = [evaluate_depth(depth[i:i + 1], gt[i:i + 1], nlabel=cfg.depth.nlabel,
                          min_depth=cfg.depth.min_depth,
                          raw_hw=None if raw_hw is None else raw_hw[i:i + 1],
                          protocol=cfg.data.eval_protocol)
           for i in range(depth.shape[0])]
    w = batch.get("sample_valid")
    w = torch.ones(depth.shape[0], device=depth.device) if w is None else w.float()
    wsum = torch.clamp(torch.sum(w), min=1.0)
    metrics = {k: torch.sum(torch.stack([m[k] for m in per]) * w) / wsum for k in per[0]}
    if out.get("num_matches") is not None:
        nm = out["num_matches"].float()
        metrics["num_matches"] = torch.sum(nm * w) / wsum
        metrics["uniform_fallback"] = torch.sum(
            (nm < cfg.pose.min_matches).float() * w) / wsum
    return metrics, out


def validate(loader, model, cfg: SfMConfig, generator: Optional[torch.Generator] = None,
             logger=None, metric_logger=None) -> Dict[str, float]:
    """Mean metrics over `loader`. `generator` drives the sampler and RANSAC
    draws of every batch in turn.

    As the JAX package's production `validate` (`loop.py:293-361`, one batch
    per dispatch): with a `logger`, a line `Test: [done/n]\t abs_rel x`
    after the first batch and every `train.print_freq` batches after it,
    and the final means; with a `metric_logger`, the `test/*` image panes
    (input, flow, predicted and ground-truth depth of the batch's first
    pair) each time the count of batches done reaches a multiple of
    `train.image_freq`, at step = that count. The panes come from the
    forward that gave the metrics; JAX runs a second one for them."""
    from deep_sfm_revisited_tpu_torch.train.loop import emit_images

    device = next(model.parameters()).device
    meters: Dict[str, AverageMeter] = {}
    n_batches, print_freq, image_freq = len(loader), cfg.train.print_freq, cfg.train.image_freq
    next_print = 0
    for done, host_batch in enumerate(loader, start=1):
        batch = batch_to_device(host_batch, device)
        metrics, out = eval_metrics(model, cfg, batch, generator)
        n = (float(np.sum(host_batch["sample_valid"])) if "sample_valid" in host_batch
             else host_batch["ref"].shape[0])
        for name, v in metrics.items():
            meters.setdefault(name, AverageMeter()).update(float(v), n)
        if logger is not None and done >= next_print:
            logger.info(f"Test: [{done}/{n_batches}]\t abs_rel {meters['abs_rel'].avg:.4f}")
            next_print = done + print_freq
        if metric_logger is not None and image_freq > 0 and done % image_freq == 0:
            emit_images(metric_logger, "test", batch, out["flow"], out["depth"], done)
    final = {k: m.avg for k, m in meters.items()}
    if logger is not None:
        logger.info(" ".join(f"{k} {v:.4f}" for k, v in sorted(final.items())))
    return final
