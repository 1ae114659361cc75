"""Flow -> correspondence sampling (port of `ops/flow_ops.py`).

The random draws of the JAX sampler (the candidate-grid jitter,
`flow_ops.py:58`, and the Gumbel uniforms, `:173-175`) are injectable
tensors here, so a test can hand both sides the same numbers; when not
given they are drawn from an explicit `torch.Generator`.

`texture_pseudo_entropy` is the image-driven sampling weight of
`pose.sampler="texture"`: the Shi-Tomasi score in plain torch (the JAX
function has no Pallas kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deep_sfm_revisited_tpu_torch.ops.camera import pixel_grid


def flow2coord(flow: torch.Tensor):
    """Flow (B, H, W, 2) -> homogeneous grids (coord1, coord2), (B, H, W, 3)."""
    b, h, w, _ = flow.shape
    grid = torch.movedim(pixel_grid(h, w, flow.dtype, flow.device), 0, -1)
    coord1 = grid[None].expand(b, h, w, 3)
    coord2 = torch.cat([coord1[..., :2] + flow, coord1[..., 2:]], dim=-1)
    return coord1, coord2


def texture_pseudo_entropy(image: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Shi-Tomasi texture score as a pseudo-entropy map (low = textured =
    trustworthy), the `conf` of `sample_correspondences` (JAX
    `flow_ops.py:67-103`). image (B, H, W, 3) -> (B, H, W, 1).

    Mean gray, edge-padded central differences, the structure tensor
    box-filtered over `window` x `window` with zero padding ("SAME"), its
    smaller eigenvalue normalized by the per-image maximum, as 1 - score.
    """
    gray = image.float().mean(dim=-1)[:, None]                    # (B, 1, H, W)
    gp = F.pad(gray, (1, 1, 1, 1), mode="replicate")
    ix = 0.5 * (gp[:, :, 1:-1, 2:] - gp[:, :, 1:-1, :-2])
    iy = 0.5 * (gp[:, :, 2:, 1:-1] - gp[:, :, :-2, 1:-1])
    k = torch.full((1, 1, window, window), 1.0 / (window * window), device=image.device)

    def box(x):
        return F.conv2d(x, k, padding=window // 2)

    sxx, sxy, syy = box(ix * ix), box(ix * iy), box(iy * iy)
    half_tr = 0.5 * (sxx + syy)
    rad = torch.sqrt(torch.clamp((0.5 * (sxx - syy)) ** 2 + sxy ** 2, min=0.0))
    lam_min = torch.clamp(half_tr - rad, min=0.0)
    peak = lam_min.amax(dim=(1, 2, 3), keepdim=True)
    score = lam_min / torch.clamp(peak, min=1e-12)
    return (1.0 - score).permute(0, 2, 3, 1)


def _grid_shape(h: int, w: int, margin: int, n: int):
    ih, iw = h - 2 * margin, w - 2 * margin
    aspect = iw / ih
    ny = max(int(round((n / aspect) ** 0.5)), 1)
    nx = max(n // ny, 1)
    return ih, iw, ny, nx


def _candidate_grid(b, h, w, margin, n, dtype, device, jitter=None):
    """Stride grid of exactly n points inside `margin`, (B, n, 2) as (x, y).

    `jitter` (B, n, 2): uniform draws in [-0.5, 0.5), scaled by the grid
    cell and clipped to the margin (JAX `_candidate_grid`, `:42-64`).
    """
    ih, iw, ny, nx = _grid_shape(h, w, margin, n)
    ys = torch.linspace(margin, h - 1 - margin, ny, dtype=torch.float64, device=device)
    xs = torch.linspace(margin, w - 1 - margin, nx, dtype=torch.float64, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    reps = -(-n // pts.shape[0])
    pts = pts.repeat(reps, 1)[:n]
    pts = pts[None].expand(b, n, 2).to(dtype)
    if jitter is not None:
        cell = torch.tensor([iw / nx, ih / ny], dtype=dtype, device=device)
        lo = torch.tensor([margin, margin], dtype=dtype, device=device)
        hi = torch.tensor([w - 1 - margin, h - 1 - margin], dtype=dtype, device=device)
        pts = torch.minimum(torch.maximum(pts + jitter.to(dtype) * cell, lo), hi)
    return pts


def sample_correspondences(
    flow: torch.Tensor,
    K_inv: torch.Tensor,
    num_points: int,
    margin: int = 10,
    conf: torch.Tensor | None = None,
    min_matches: int = 20,
    oversample: int = 4,
    good_entropy: float = 0.7,
    jitter: torch.Tensor | None = None,
    gumbel_u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
):
    """Subsample K^-1-normalized correspondences from dense flow.

    flow (B, H, W, 2); K_inv (B, 3, 3). Returns (x1, x2), each
    (B, num_points, 2); with `conf` (B, H, W, 1) normalized entropy, also
    num_good (B,). Semantics of JAX `sample_correspondences` (`:109-193`):
    an `oversample`x candidate grid scored by w = 1 - entropy, the top
    `num_points` kept (Gumbel-perturbed when drawing), and the uniform grid
    when fewer than `min_matches` candidates are confident.

    Randomness: `jitter` (B, n_cand, 2) in [-0.5, 0.5) and `gumbel_u`
    (B, n_cand) in [1e-12, 1) are the raw draws; if `generator` is given,
    missing draws come from it; with neither, the grid is not jittered and
    the selection not perturbed (the JAX `key=None` path).
    Selection math runs in f32 for f64 flow; the gathered flow keeps its
    dtype (`:150-157`). Top-k ties go to the lower candidate index, as
    `lax.top_k`.
    """
    b, h, w, _ = flow.shape
    dev = flow.device
    sdtype = torch.float32 if flow.dtype == torch.float64 else flow.dtype
    n_cand = num_points * (oversample if conf is not None else 1)
    if generator is not None and jitter is None:
        jitter = torch.rand((b, n_cand, 2), generator=generator, device=dev,
                            dtype=sdtype) - 0.5
    pts = _candidate_grid(b, h, w, margin, n_cand, sdtype, dev, jitter)
    pts_i = torch.round(pts).long()
    idx = pts_i[..., 1] * w + pts_i[..., 0]

    num_good = None
    if conf is not None:
        ent = conf.reshape(b, h * w).to(sdtype)
        e = torch.gather(ent, 1, idx)
        wgt = torch.clamp(1.0 - e, 0.0, 1.0)
        good = e < good_entropy
        num_good = torch.sum(good, dim=1)
        use_conf = (num_good >= max(min_matches, 1))[:, None]
        score = torch.where(use_conf, torch.log(wgt + 1e-6), torch.zeros_like(wgt))
        if generator is not None and gumbel_u is None:
            gumbel_u = torch.rand((b, n_cand), generator=generator, device=dev,
                                  dtype=sdtype) * (1.0 - 1e-12) + 1e-12
        if gumbel_u is not None:
            score = score - torch.log(-torch.log(gumbel_u.to(sdtype)))
        top = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :num_points]
        pts_i = torch.gather(pts_i, 1, top[..., None].expand(-1, -1, 2))
        idx = torch.gather(idx, 1, top)

    flat = flow.reshape(b, h * w, 2)
    f = torch.gather(flat, 1, idx[..., None].expand(-1, -1, 2))
    p1 = pts_i.to(flow.dtype)
    p2 = p1 + f
    ones = torch.ones_like(p1[..., :1])
    n1 = torch.einsum("bij,bnj->bni", K_inv, torch.cat([p1, ones], dim=-1))
    n2 = torch.einsum("bij,bnj->bni", K_inv, torch.cat([p2, ones], dim=-1))
    if conf is not None:
        return n1[..., :2], n2[..., :2], num_good
    return n1[..., :2], n2[..., :2]
