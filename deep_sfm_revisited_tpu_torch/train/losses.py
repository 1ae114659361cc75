"""The training losses (port of `deep_sfm_revisited_tpu/train/losses.py:24-107`).

The reference's masked smooth-L1 on depth_init and depth (`main.py:350-394`,
"follow the setting of DPSNet") with the RESCALE_DEPTH scale window, as
mask-weighted means (the JAX package's form: no boolean indexing, so every
batch has one shape); and the PoseNet route's MSE pose loss
(`main.py:396-408`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from deep_sfm_revisited_tpu_torch.ops.rotations import pose_to_rt


def smooth_l1(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Elementwise Huber / smooth-L1 with beta = 1 (torch `F.smooth_l1_loss`)."""
    d = torch.abs(pred - gt)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    w = mask.to(x.dtype)
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def depth_training_loss(
    depth_init: torch.Tensor,     # (B, H, W) pre-context prediction
    depth: torch.Tensor,          # (B, H, W) refined prediction
    depth_gt: torch.Tensor,       # (B, H, W) sparse GT (0 where absent)
    pose_gt: torch.Tensor,        # (B, 3, 4) GT relative pose (metric)
    nlabel: int,
    min_depth: float,
    rescale_depth: bool = True,
    norm_target: float = 0.6,
    min_train_scale: float = 0.2,
    max_train_scale: float = 2.0,
    init_weight: float = 0.7,
    remask: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked smooth-L1 depth loss -> (loss, {depth_init, depth_out, valid_frac}).

    The validity mask keeps MIN_DEPTH <= gt <= nlabel MIN_DEPTH and finite
    values. With RESCALE_DEPTH the refined prediction (at the NORM_TARGET
    scale) is rescaled by |t_gt| / NORM_TARGET, depth_init is supervised as
    it is (`main.py:364` rescales the refined output alone), frames whose GT
    translation norm lies outside (MIN_TRAIN_SCALE, MAX_TRAIN_SCALE) leave
    the loss, and with `remask` the mask is taken against the de-rescaled
    GT (RESCALE_DEPTH_REMASK, `main.py:366-372`).
    """
    def in_range(gt):
        return (gt >= min_depth) & (gt <= nlabel * min_depth) & torch.isfinite(gt)

    valid = in_range(depth_gt)
    scale = torch.linalg.vector_norm(pose_gt[:, :3, 3], dim=-1)   # (B,)
    if rescale_depth:
        scale_ok = (scale > min_train_scale) & (scale < max_train_scale)
        ratio = (scale / norm_target)[:, None, None]
        depth = depth * ratio
        if remask:
            valid = in_range(depth_gt / ratio)
    else:
        scale_ok = scale > min_train_scale
    mask = valid & scale_ok[:, None, None]

    loss_init = _masked_mean(smooth_l1(depth_init, depth_gt), mask)
    loss_out = _masked_mean(smooth_l1(depth, depth_gt), mask)
    loss = init_weight * loss_init + loss_out
    return loss, {"depth_init": loss_init, "depth_out": loss_out,
                  "valid_frac": _masked_mean(torch.ones_like(depth_gt), mask)}


def pose_regression_loss(rt_pred: torch.Tensor, pose_gt: torch.Tensor,
                         rot_weight: float = 20.0) -> torch.Tensor:
    """MSE of PoseNet's (rot3, unit trans3) against the GT pose's Euler
    angles and unit translation, per dimension over the batch, the rotation
    dimensions weighted by `rot_weight` (JAX `losses.py:93-107`)."""
    rt_gt = pose_to_rt(pose_gt)
    t = rt_gt[:, 3:]
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    target = torch.cat([rt_gt[:, :3], t], dim=-1)
    per_dim = torch.mean((rt_pred - target) ** 2, dim=0)            # (6,)
    weight = torch.tensor([rot_weight] * 3 + [1.0] * 3, dtype=per_dim.dtype,
                          device=per_dim.device)
    return torch.mean(per_dim * weight)
