"""Evaluation metrics (port of `deep_sfm_revisited_tpu/train/metrics.py`).

The KITTI Eigen depth protocol of the reference's `main.py:560-630`: the
validity mask 0 < d < 80 m inside the Eigen crop window (or the DeMoN mask),
per-image median scale alignment, the clamp to [MIN_DEPTH,
nlabel * MIN_DEPTH], and the 9 scalar metrics; and the DeMoN motion errors.
Masked reductions as in the JAX package (weighted means over the mask, no
boolean indexing), so padded inputs evaluate exactly as unpadded ones.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deep_sfm_revisited_tpu_torch.ops.rotations import matrix_to_quat


def _mmean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    w = mask.to(x.dtype)
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def eigen_crop_mask(depth_gt: torch.Tensor, max_depth: float = 80.0,
                    raw_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eigen evaluation mask (JAX `eigen_crop_mask`). depth_gt (B, H, W);
    `raw_hw` (B, 2) per-image pre-pad (h, w): the crop window is computed on
    the raw dims (in float64, as the reference's numpy) and padded rows and
    columns are masked out."""
    b, h, w = depth_gt.shape
    dev, f64 = depth_gt.device, torch.float64
    valid = (depth_gt > 0) & (depth_gt < max_depth)
    if raw_hw is None:
        rh = torch.full((b,), float(h), dtype=f64, device=dev)
        rw = torch.full((b,), float(w), dtype=f64, device=dev)
    else:
        rh, rw = raw_hw[:, 0].to(f64), raw_hw[:, 1].to(f64)
    y0 = torch.floor(0.40810811 * rh)[:, None, None]
    y1 = torch.floor(0.99189189 * rh)[:, None, None]
    x0 = torch.floor(0.03594771 * rw)[:, None, None]
    x1 = torch.floor(0.96405229 * rw)[:, None, None]
    ys = torch.arange(h, dtype=f64, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=f64, device=dev)[None, None, :]
    crop = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    in_raw = (ys < rh[:, None, None]) & (xs < rw[:, None, None])
    return valid & crop & in_raw


def demon_mask(depth_gt: torch.Tensor, raw_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DeMoN-protocol mask: 0.5 <= d <= 10 m, finite, no crop window."""
    b, h, w = depth_gt.shape
    valid = (depth_gt >= 0.5) & (depth_gt <= 10.0) & torch.isfinite(depth_gt)
    if raw_hw is not None:
        ys = torch.arange(h, device=depth_gt.device)[None, :, None]
        xs = torch.arange(w, device=depth_gt.device)[None, None, :]
        valid = valid & (ys < raw_hw[:, :1, None]) & (xs < raw_hw[:, 1:, None])
    return valid


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of the masked entries of a 1-D x, the sort form of the JAX
    package (`_masked_median_sort`, `:85`): invalid entries go to +inf and
    the two middle order statistics come from the valid count; 1.0 when
    nothing is valid. Exact, like the JAX bisection form."""
    n = x.shape[0]
    s, _ = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))))
    cnt = torch.sum(mask)
    mid = torch.clamp(cnt - 1, min=0) // 2
    lo = s[torch.clamp(mid, 0, n - 1)]
    hi = s[torch.clamp(cnt - 1 - mid, 0, n - 1)]
    return torch.where(cnt > 0, 0.5 * (lo + hi), torch.ones_like(lo))


def median_scale_align(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-image median(gt) / median(pred) rescale (`main.py:576-585`)."""
    b = pred.shape[0]
    p, g, m = pred.reshape(b, -1), gt.reshape(b, -1), mask.reshape(b, -1)
    med_p = torch.stack([_masked_median(p[i], m[i]) for i in range(b)])
    med_g = torch.stack([_masked_median(g[i], m[i]) for i in range(b)])
    scale = med_g / torch.clamp(med_p, min=1e-12)
    return pred * scale[:, None, None]


def depth_metrics(gt: torch.Tensor, pred: torch.Tensor,
                  mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 9 depth metrics over masked pixels (`main.py:727-747`); masked-out
    entries are replaced before any arithmetic, so NaN GT outside the mask
    cannot reach the sums."""
    eps = 1e-12
    one = torch.ones_like(gt)
    g = torch.clamp(torch.where(mask, gt, one), min=eps)
    p = torch.clamp(torch.where(mask, pred, one), min=eps)
    thresh = torch.maximum(g / p, p / g)
    log_d = torch.log(g) - torch.log(p)
    mean_logd = _mmean(log_d, mask)
    sc_inv = torch.sqrt(torch.clamp(_mmean(log_d ** 2, mask) - mean_logd ** 2, min=0.0))
    return {
        "abs_rel": _mmean(torch.abs(g - p) / g, mask),
        "sq_rel": _mmean((g - p) ** 2 / g, mask),
        "rmse": torch.sqrt(_mmean((g - p) ** 2, mask)),
        "rmse_log": torch.sqrt(_mmean(log_d ** 2, mask)),
        "a1": _mmean((thresh < 1.25).to(g.dtype), mask),
        "a2": _mmean((thresh < 1.25 ** 2).to(g.dtype), mask),
        "a3": _mmean((thresh < 1.25 ** 3).to(g.dtype), mask),
        "l1_inv": _mmean(torch.abs(1.0 / g - 1.0 / p), mask),
        "sc_inv": sc_inv,
    }


def evaluate_depth(pred: torch.Tensor, gt: torch.Tensor, nlabel: int, min_depth: float,
                   max_depth: float = 80.0, median_scale: bool = True,
                   raw_hw: Optional[torch.Tensor] = None,
                   protocol: str = "eigen") -> Dict[str, torch.Tensor]:
    """Mask + median alignment + clamp + metrics (`main.py:560-630`);
    `protocol` "eigen" (KITTI crop window) or "demon" (0.5-10 m, no crop)."""
    if protocol == "demon":
        mask = demon_mask(gt, raw_hw=raw_hw)
    else:
        mask = eigen_crop_mask(gt, max_depth, raw_hw=raw_hw)
    if median_scale:
        pred = median_scale_align(pred, gt, mask)
    pred = torch.clamp(pred, min_depth, nlabel * min_depth)
    return depth_metrics(gt, pred, mask)


def motion_errors(pred_pose: torch.Tensor,
                  gt_pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rotation angle error, normalized-translation L2, translation angle
    error) of (..., 3, 4) poses (DeMoN's `compute_motion_errors`), with the
    quaternion angular distance."""
    q1 = matrix_to_quat(pred_pose[..., :3, :3])
    q2 = matrix_to_quat(gt_pose[..., :3, :3])
    dot = torch.abs(torch.sum(q1 * q2, dim=-1))
    rot_err = 2.0 * torch.arccos(torch.clamp(dot, -1.0, 1.0))
    t1, t2 = pred_pose[..., :3, 3], gt_pose[..., :3, 3]
    n1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), min=1e-12)
    n2 = t2 / torch.clamp(torch.linalg.vector_norm(t2, dim=-1, keepdim=True), min=1e-12)
    trans_dist = torch.linalg.vector_norm(n1 - n2, dim=-1)
    trans_angle = torch.arccos(torch.clamp(torch.sum(n1 * n2, dim=-1), -1.0, 1.0))
    return rot_err, trans_dist, trans_angle
