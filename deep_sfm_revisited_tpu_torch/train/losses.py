"""The training losses (port of `deep_sfm_revisited_tpu/train/losses.py:24-189`).

The reference's masked smooth-L1 on depth_init and depth (`main.py:350-394`,
"follow the setting of DPSNet") with the RESCALE_DEPTH scale window, as
mask-weighted means (the JAX package's form: no boolean indexing, so every
batch has one shape); the PoseNet route's MSE pose loss
(`main.py:396-408`); and the flow losses: the end-point error
(`loss_functions.py:247-288`), RAFT's sequence loss and DICL's multiscale
L1 (`MultiScale_UP`, `loss_functions.py:15-62`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

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


def flow_epe(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """End-point error of (B, H, W, 2) flows, the mean over `valid` (B, H, W)
    where given (JAX `flow_epe`)."""
    epe = torch.linalg.vector_norm(flow_pred - flow_gt, dim=-1)
    if valid is None:
        return torch.mean(epe)
    return _masked_mean(epe, valid)


def flow_sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                       valid: Optional[torch.Tensor] = None, gamma: float = 0.8,
                       max_flow: float = 400.0) -> torch.Tensor:
    """RAFT's exponentially weighted L1 over the iterations (iters, B, H, W,
    2): iteration i weighs gamma^(n - i - 1); pixels with |gt| >= max_flow
    or not `valid` leave each mean (JAX `flow_sequence_loss`)."""
    n = flow_preds.shape[0]
    v = torch.linalg.vector_norm(flow_gt, dim=-1) < max_flow
    if valid is not None:
        v = v & valid.bool()
    total = 0.0
    for i in range(n):
        l1 = torch.sum(torch.abs(flow_preds[i] - flow_gt), dim=-1)
        total = total + gamma ** (n - i - 1) * _masked_mean(l1, v)
    return total


def multiscale_flow_loss(flow_pyramid: Sequence[torch.Tensor], flow_gt: torch.Tensor,
                         weights: Sequence[float], valid: Optional[torch.Tensor] = None,
                         valid_range=None) -> torch.Tensor:
    """DICL's multiscale L1 (JAX `multiscale_flow_loss`, the reference's
    `MultiScale_UP`): per level, |pred - gt| summed over (u, v) against the
    GT average-pooled to the prediction's size (and divided by the pool
    factor); with `valid_range`, a pixel whose pooled GT exceeds the level's
    (vy, vx) is zeroed but still counted in the mean; with `valid`, the mean
    runs over the pixels whose pooled mask exceeds 0.5. Levels weigh
    `weights`; the total is divided by the number of levels.

    The GT must tile every prediction (H, W multiples of its h, w), as JAX's
    reshape requires: DICL pads its input to /128 and the loader pads the
    images but not `flow_gt`, so a flow crop that is not a multiple of 128
    on each side raises here (JAX raises a TypeError from its reshape)."""
    B, H, W, _ = flow_gt.shape
    total, n = 0.0, 0
    for i, (w_lvl, pred) in enumerate(zip(weights, flow_pyramid)):
        h, wd = pred.shape[1], pred.shape[2]
        fy, fx = H // h, W // wd
        if fy * h != H or fx * wd != W:
            raise ValueError(
                f"flow GT {H}x{W} does not tile the {h}x{wd} prediction: DICL pads its input "
                "to a multiple of 128 and flow_gt is not padded, so the flow crop's sides "
                "must be multiples of 128 (e.g. --flow-crop 256 768)")
        gt = flow_gt.reshape(B, h, fy, wd, fx, 2).mean(dim=(2, 4))
        gt = gt / torch.tensor([fx, fy], dtype=gt.dtype, device=gt.device)
        l1 = torch.sum(torch.abs(pred - gt), dim=-1)
        mask = torch.ones_like(l1, dtype=torch.bool)
        if valid_range is not None and i < len(valid_range):
            vy, vx = valid_range[i]
            mask = mask & (torch.abs(gt[..., 0]) <= vx) & (torch.abs(gt[..., 1]) <= vy)
        zeroed = torch.where(mask, l1, torch.zeros_like(l1))
        if valid is not None:
            vv = valid.to(gt.dtype).reshape(B, h, fy, wd, fx).mean(dim=(2, 4)) > 0.5
            total = total + w_lvl * _masked_mean(zeroed, vv)
        else:
            # zeroed-but-counted mean, as the reference
            total = total + w_lvl * torch.mean(zeroed)
        n += 1
    return total / max(n, 1)
