"""Eigen-protocol evaluation of SFMNet (port of the JAX package's eval step,
`train/trainer.py:443-507`, and of the plain form of `train/loop.py::
validate`, `:236-290`).

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


def validate(loader, model, cfg: SfMConfig,
             generator: Optional[torch.Generator] = None) -> Dict[str, float]:
    """Mean metrics over `loader` (`validate`, plain form). `generator`
    drives the sampler and RANSAC draws of every batch in turn."""
    device = next(model.parameters()).device
    meters: Dict[str, AverageMeter] = {}
    for host_batch in loader:
        metrics, _ = eval_metrics(model, cfg, batch_to_device(host_batch, device), generator)
        n = (float(np.sum(host_batch["sample_valid"])) if "sample_valid" in host_batch
             else host_batch["ref"].shape[0])
        for name, v in metrics.items():
            meters.setdefault(name, AverageMeter()).update(float(v), n)
    return {k: m.avg for k, m in meters.items()}
