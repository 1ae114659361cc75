"""Camera / warping ops (port of `deep_sfm_revisited_tpu/ops/camera.py`).

Layouts as in the JAX package: images/features (B, H, W, C), flow
(B, H, W, 2) as (dx, dy), depth (B, H, W), intrinsics (B, 3, 3), pose
(B, 3, 4) ref->target.

Two ops here have hand-written kernels in kernel B1's source
(`csrc/sweep_warp.cu`, wrapper `ops/cuda/sweep_warp.py`): `bilinear_sample`
(the generic gather) and `plane_sweep_volume` (PSNet's fused cost volume,
whose gradients, `PlaneSweepVolumeFn`, are two more kernels of the same
source: with respect to the features, and with respect to M = K R K^-1 and
K t, the pose). A third, `sweep_correlation` (REGNet's correlation over
plane depths and pose hypotheses), is kernel K1 with its backward K2
(`csrc/sweep_corr.cu`, wrapper `ops/cuda/sweep_corr.py`,
`SweepCorrelationFn`). On CUDA tensors each launches its kernel; on CPU
tensors each runs its plain PyTorch version (`bilinear_sample_plain`,
`plane_sweep_volume_plain`, `plane_sweep_volume_backward_plain`,
`plane_sweep_volume_pose_grad_plain`, `sweep_correlation_plain`,
`sweep_correlation_backward_plain`). There is no fallback from one to the
other.
"""

from __future__ import annotations

import torch

from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_corr, sweep_warp


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel grid (3, H, W) of (u, v, 1) = (x/col, y/row, 1)."""
    v, u = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([u, v, torch.ones_like(u)], dim=0)


def pixel2cam(depth: torch.Tensor, K_inv: torch.Tensor) -> torch.Tensor:
    """Back-project pixels: depth (B, H, W), K_inv (B, 3, 3) -> (B, 3, H, W)."""
    b, h, w = depth.shape
    grid = pixel_grid(h, w, depth.dtype, depth.device).reshape(3, -1)
    cam = torch.einsum("bij,jn->bin", K_inv, grid).reshape(b, 3, h, w)
    return cam * depth[:, None]


def _divide(p0, p1, p2, h: int, w: int):
    """Perspective divide of points (p0, p1, p2) with the out-of-frustum trick.

    Z is clamped to 1e-3; a point at or behind that plane is sent to
    (2w, 2h), far outside the image, so `bilinear_sample` zeroes it
    (the reference's coordinate-2 trick, `models/inverse_warp.py:68-72`).
    """
    z = torch.clamp(p2, min=1e-3)
    invalid = p2 <= 1e-3
    x = torch.where(invalid, torch.full_like(z, 2.0 * w), p0 / z)
    y = torch.where(invalid, torch.full_like(z, 2.0 * h), p1 / z)
    return x, y


def _project(p: torch.Tensor, h: int, w: int):
    """`_divide` of (..., 3, N) points."""
    return _divide(p[..., 0, :], p[..., 1, :], p[..., 2, :], h, w)


def cam2pixel(cam: torch.Tensor, proj_rot: torch.Tensor,
              proj_tr: torch.Tensor) -> torch.Tensor:
    """cam (B, 3, H, W), proj_rot (B, 3, 3), proj_tr (B, 3, 1) -> (B, H, W, 2)
    pixel coordinates (JAX `cam2pixel`, `camera.py:52-72`)."""
    b, _, h, w = cam.shape
    flat = cam.reshape(b, 3, -1)
    p = torch.einsum("bij,bjn->bin", proj_rot, flat) + proj_tr
    x, y = _project(p, h, w)
    return torch.stack([x, y], dim=-1).reshape(b, h, w, 2)


def _taps(x: torch.Tensor, y: torch.Tensor, H: int, W: int):
    """B1's sampling rule at pixel coordinates (x, y): (valid, (yi, xi, yi1,
    xi1), (wx, wy)). `valid` is False where the PRE-clip (x, y) lies outside
    [0, W-1] x [0, H-1]; the taps are the clamped integer corners (the +1
    taps clamp at the last row/column, where their weight is 0) and wx, wy
    the float32 fractions."""
    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x = torch.clamp(x, 0.0, W - 1)
    y = torch.clamp(y, 0.0, H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xi = x0.long().clamp(0, W - 1)
    yi = y0.long().clamp(0, H - 1)
    xi1 = (xi + 1).clamp(max=W - 1)
    yi1 = (yi + 1).clamp(max=H - 1)
    return valid, (yi, xi, yi1, xi1), (x - x0, y - y0)


def bilinear_sample_plain(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Kernel B1's plain PyTorch version (JAX `bilinear_sample`, `:75-126`).

    img (B, H, W, C); coords (B, ..., 2) as (x, y) pixels -> (B, ..., C) in
    img's dtype. align_corners=True; a sample whose PRE-clip (x, y) lies
    outside [0, W-1] x [0, H-1] is exactly zero. Taps and weights are read
    and blended in float32 (bf16 images included; float64 images in
    float64), then cast back.
    """
    B, H, W, C = img.shape
    out_shape = coords.shape[:-1] + (C,)
    xy = coords.reshape(B, -1, 2).to(torch.float32)
    valid, (yi, xi, yi1, xi1), (wx, wy) = _taps(xy[..., 0], xy[..., 1], H, W)
    wx, wy = wx[..., None], wy[..., None]
    flat = img.reshape(B, H * W, C).to(torch.promote_types(img.dtype, torch.float32))

    def tap(yy, xx):
        idx = (yy * W + xx)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx)

    top = tap(yi, xi) * (1 - wx) + tap(yi, xi1) * wx
    bot = tap(yi1, xi) * (1 - wx) + tap(yi1, xi1) * wx
    out = (top * (1 - wy) + bot * wy) * valid[..., None].to(flat.dtype)
    return out.reshape(out_shape).to(img.dtype)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with zero padding, align_corners=True.

    img (B, H, W, C) f32 or bf16; coords (B, ..., 2) pixel (x, y), always
    cast to float32 (half-precision coordinates lose whole pixels, as the
    JAX docstring explains). A CUDA image goes through kernel B1, a CPU
    image through `bilinear_sample_plain`.
    """
    coords = coords.to(torch.float32)
    if img.device.type == "cuda":
        return sweep_warp.bilinear_sample_cuda(img.contiguous(), coords.contiguous())
    if img.device.type == "cpu":
        return bilinear_sample_plain(img, coords)
    raise NotImplementedError(f"bilinear_sample on {img.device.type}")


def inverse_warp(feat, depth, pose, K, K_inv):
    """Warp target features (B,H,W,C) into the ref view given ref depth."""
    cam = pixel2cam(depth, K_inv)
    proj = torch.einsum("bij,bjk->bik", K, pose)
    coords = cam2pixel(cam, proj[:, :, :3], proj[:, :, 3:])
    return bilinear_sample(feat, coords)


def pose2flow(depth, pose, K, K_inv) -> torch.Tensor:
    """Rigid flow (B, H, W, 2) induced by ref depth (B, H, W) and pose."""
    b, h, w = depth.shape
    cam = pixel2cam(depth, K_inv)
    proj = torch.einsum("bij,bjk->bik", K, pose)
    coords = cam2pixel(cam, proj[:, :, :3], proj[:, :, 3:])
    grid = pixel_grid(h, w, depth.dtype, depth.device)[:2]
    return coords - torch.movedim(grid, 0, -1)[None]


def sweep_matrices(pose, K, K_inv):
    """M = K R K^-1 (B, 3, 3) and K t (B, 3) of ref->target poses (B, 3, 4).

    Computed on the inputs' device, so the sweep kernel reads them there
    (no host round trip).
    """
    M = torch.einsum("bij,bjk,bkl->bil", K, pose[:, :, :3], K_inv)
    Kt = torch.einsum("bij,bj->bi", K, pose[:, :, 3])
    return M.contiguous(), Kt.contiguous()


def sweep_points(depths, M, Kt, h: int, w: int):
    """The points p = (M [u, v, 1]) d + K t, (p0, p1, p2) each (B, D, H, W), of
    every ref pixel (u, v) on the fronto-parallel plane at each depth d.

    Written in the sweep kernel's op order, one rounding per op: the ray
    ray_i = (M_i0 u + M_i1 v) + M_i2 once per pixel, p_i = ray_i d + (K t)_i
    per plane (no einsum over the pixel grid, whose sums may fuse or reorder).
    """
    dev = depths.device
    u = torch.arange(w, dtype=M.dtype, device=dev)[None, None, :]
    v = torch.arange(h, dtype=M.dtype, device=dev)[None, :, None]
    d = depths.to(M.dtype)[None, :, None, None]
    p = []
    for i in range(3):
        m = M[:, i, :, None, None]                                    # (B, 3, 1, 1)
        ray = (m[:, 0] * u + m[:, 1] * v) + m[:, 2]                   # (B, H, W)
        p.append(ray[:, None] * d + Kt[:, i, None, None, None])      # (B, D, H, W)
    return p


def sweep_pixel_coords(depths, M, Kt, h: int, w: int):
    """Target-view pixel (x, y), each (B, D, H, W), of ref pixel (u, v) on the
    fronto-parallel plane at each depth d: `sweep_points`, then `_divide`
    (JAX `plane_sweep_coords`, `camera.py:165-195`)."""
    return _divide(*sweep_points(depths, M, Kt, h, w), h, w)


def plane_sweep_coords(depths, pose, K, K_inv, h: int, w: int) -> torch.Tensor:
    """Sampling coords (B, D, H, W, 2) for D fronto-parallel planes at once."""
    M, Kt = sweep_matrices(pose, K, K_inv)
    return torch.stack(sweep_pixel_coords(depths, M, Kt, h, w), dim=-1)


def plane_sweep_warp(feat, depths, pose, K, K_inv) -> torch.Tensor:
    """Warp target features over all D planes: (B,H,W,C) -> (B,D,H,W,C)."""
    B, H, W, C = feat.shape
    coords = plane_sweep_coords(depths, pose, K, K_inv, H, W)
    return bilinear_sample(feat, coords)


def plane_sweep_volume_plain(ref, tgt, depths, M, Kt) -> torch.Tensor:
    """The sweep kernel's plain PyTorch version: the cost volume
    (B, D, H, W, 2C) of [ref | tgt warped onto each plane], in the
    features' dtype (JAX `models/psnet.py:253-260`).

    ref, tgt (B, H, W, C); depths (D,); M (B, 3, 3), Kt (B, 3) float32, the
    tensors the kernel gets. Coordinates by `sweep_pixel_coords`, samples by
    `bilinear_sample_plain`.
    """
    H, W = tgt.shape[1:3]
    coords = torch.stack(sweep_pixel_coords(depths, M, Kt, H, W), dim=-1)
    warped = bilinear_sample_plain(tgt, coords)                      # (B, D, H, W, C)
    return torch.cat([ref[:, None].expand_as(warped), warped], dim=-1)


def plane_sweep_volume_backward_plain(dvol, depths, M, Kt):
    """The sweep backward kernel's plain PyTorch version: the explicit VJP of
    `plane_sweep_volume_plain` with respect to its two feature maps.

    dvol (B, D, H, W, 2C), the volume's gradient; depths, M, Kt as the
    forward took them. Returns (dref, dtgt), each (B, H, W, C) in dvol's
    dtype: dref sums dvol's ref half over the planes; dtgt gathers, for
    every sample, its warped-half gradient times each tap's bilinear weight
    onto the four taps the forward read (`index_add_` into float32). A sample
    the forward zeroed (out of the frame, or behind the camera) adds nothing.
    """
    B, D, H, W, C2 = dvol.shape
    C = C2 // 2
    g = dvol.to(torch.promote_types(dvol.dtype, torch.float32))
    dref = g[..., :C].sum(dim=1)
    x, y = sweep_pixel_coords(depths, M, Kt, H, W)
    valid, (yi, xi, yi1, xi1), (wx, wy) = _taps(x.reshape(B, -1), y.reshape(B, -1), H, W)
    gw = g[..., C:].reshape(B, -1, C) * valid[..., None].to(g.dtype)
    ax, ay = 1 - wx, 1 - wy
    base = (torch.arange(B, device=dvol.device) * (H * W))[:, None]
    acc = torch.zeros((B * H * W, C), dtype=g.dtype, device=dvol.device)
    for yy, xx, w in ((yi, xi, ay * ax), (yi, xi1, ay * wx),
                      (yi1, xi, wy * ax), (yi1, xi1, wy * wx)):
        acc.index_add_(0, (base + yy * W + xx).reshape(-1), (gw * w[..., None]).reshape(-1, C))
    return dref.to(dvol.dtype), acc.reshape(B, H, W, C).to(dvol.dtype)


def plane_sweep_volume_pose_grad_plain(dvol, tgt, depths, M, Kt):
    """The sweep pose-gradient kernel's plain PyTorch version: the VJP of
    `plane_sweep_volume_plain` with respect to M (B, 3, 3) and K t (B, 3),
    as `jax.vjp` of the JAX package's volume gives it.

    dvol (B, D, H, W, 2C), the volume's gradient (its ref half plays no
    part); tgt (B, H, W, C), the features the forward warped; depths, M, Kt
    as the forward took them. Returns (dM, dKt) in M's dtype.

    Per sample, with the forward's point p, z = p2, pixel (x, y) = (p0/z,
    p1/z) and its taps (`_taps`): g_x = sum_c dvol_c (d blend / d x), from
    the four taps' differences, and g_y likewise, each times 1/2 where the
    coordinate lies exactly on the frame's first or last row or column (the
    JAX gradient of its clip there), with a +1 tap beyond the frame read as
    zero (the JAX gather's zero pad). Then dp = (g_x / z, g_y / z,
    -(g_x x + g_y y) / z), dM_ij += dp_i d [u, v, 1]_j and dKt_i += dp_i. A
    sample the forward zeroed (z <= 1e-3, or out of the frame) adds nothing.
    Taps, weights and edges come from the float32 coordinates the forward's
    gather reads. The tap products and the channel sum run in float32 (float64 for float64
    inputs), everything after them in float64, in the kernel's order of
    operations; only the order of the sums differs from the kernel's.
    """
    B, D, H, W, C2 = dvol.shape
    C = C2 // 2
    cdt = torch.promote_types(dvol.dtype, torch.float32)
    p0, p1, p2 = sweep_points(depths, M, Kt, H, W)
    x, y = _divide(p0, p1, p2, H, W)
    z = torch.clamp(p2, min=1e-3)
    # the gather's float32 coordinates, as the forward reads them
    x32, y32 = x.reshape(B, -1).float(), y.reshape(B, -1).float()
    valid, (yi, xi, yi1, xi1), (wx, wy) = _taps(x32, y32, H, W)
    wx, wy = wx.to(cdt)[..., None], wy.to(cdt)[..., None]
    ax, ay = 1 - wx, 1 - wy
    img = tgt.reshape(B, H * W, C).to(cdt)
    has_x1 = (xi + 1 < W).to(cdt)[..., None]
    has_y1 = (yi + 1 < H).to(cdt)[..., None]

    def tap(yy, xx):
        return torch.gather(img, 1, (yy * W + xx)[..., None].expand(-1, -1, C))

    v00 = tap(yi, xi)
    v01 = tap(yi, xi1) * has_x1
    v10 = tap(yi1, xi) * has_y1
    v11 = tap(yi1, xi1) * (has_x1 * has_y1)
    g = dvol[..., C:].reshape(B, -1, C).to(cdt)
    gx = torch.sum(g * ((v01 - v00) * ay + (v11 - v10) * wy), dim=-1)
    gy = torch.sum(g * ((v10 - v00) * ax + (v11 - v01) * wx), dim=-1)

    f64 = torch.float64
    xs, ys, zs = (t.reshape(B, -1).to(f64) for t in (x, y, z))
    edge_x = (x32 == 0) | (x32 == W - 1)
    edge_y = (y32 == 0) | (y32 == H - 1)
    gx = torch.where(valid, gx.to(f64) * torch.where(edge_x, 0.5, 1.0), 0.0)
    gy = torch.where(valid, gy.to(f64) * torch.where(edge_y, 0.5, 1.0), 0.0)
    dp = torch.stack([gx / zs, gy / zs, -(gx * xs + gy * ys) / zs], dim=1)    # (B, 3, N)
    dev = dvol.device
    d = depths.to(f64)[:, None, None].expand(D, H, W).reshape(1, 1, -1)
    u = torch.arange(W, dtype=f64, device=dev).expand(D, H, W).reshape(1, 1, -1)
    v = torch.arange(H, dtype=f64, device=dev)[:, None].expand(D, H, W).reshape(1, 1, -1)
    sd = dp * d
    dM = torch.stack([(sd * u).sum(-1), (sd * v).sum(-1), sd.sum(-1)], dim=-1)  # (B, 3, 3)
    return dM.to(M.dtype), dp.sum(-1).to(Kt.dtype)


def sweep_tap_box_plain(depths, M, Kt, H: int, W: int, tile_h: int, tile_w: int,
                        planes: int, cap: int):
    """The sweep backward kernel's box rule, in its op order: for each tile
    of tile_h x tile_w ref pixels and each group of `planes` planes, the box
    of target taps the group's samples can touch.

    The tile's four corner pixels at the group's least and greatest plane
    depth give 8 points p = (M [u, v, 1]) d + K t (`sweep_pixel_coords`'s
    rounding). If each has z > 1e-3, z exceeds 1e-3 over the whole tile and
    depth range, and every sample's (x, y) lies in their bounding box; it is
    padded by one pixel on each side for rounding and one more on the far
    side for the +1 taps, and clipped to the frame. A group is `direct`
    (its samples add to device memory one by one) when a point has
    z <= 1e-3 or the box holds more than `cap` pixels; its box is then
    empty. Returns {x0, y0, w, h, direct}, each (B, tiles_y, tiles_x,
    groups)."""
    dev, f32 = depths.device, torch.float32
    tiles_y, tiles_x = -(-H // tile_h), -(-W // tile_w)
    groups = -(-depths.shape[0] // planes)
    tx0 = torch.arange(tiles_x, device=dev) * tile_w
    ty0 = torch.arange(tiles_y, device=dev) * tile_h
    tx1, ty1 = torch.clamp(tx0 + tile_w, max=W) - 1, torch.clamp(ty0 + tile_h, max=H) - 1
    corner = torch.arange(4, device=dev)
    u = torch.where(corner % 2 == 1, tx1[:, None], tx0[:, None]).to(f32)[None]      # (1, tx, 4)
    v = torch.where(corner // 2 == 1, ty1[:, None], ty0[:, None]).to(f32)[:, None]  # (ty, 1, 4)
    pad = groups * planes - depths.shape[0]
    lo = torch.nn.functional.pad(depths.to(f32), (0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(depths.to(f32), (0, pad), value=float("-inf"))
    dep = torch.stack([lo.reshape(groups, planes).amin(1), hi.reshape(groups, planes).amax(1)],
                      dim=-1)                                                     # (G, 2)
    p = []
    for i in range(3):
        m = M[:, i].to(f32)
        ray = (m[:, 0, None, None, None] * u + m[:, 1, None, None, None] * v) \
            + m[:, 2, None, None, None]                                          # (B, ty, tx, 4)
        p.append(ray[..., None, None] * dep + Kt[:, i].to(f32)[:, None, None, None, None, None])
    def points(t):                                        # (B, ty, tx, 4, G, 2) -> (.., G, 8)
        return t.permute(0, 1, 2, 4, 3, 5).flatten(-2)

    behind = points(p[2] <= 1e-3)
    x, y = points(p[0] / p[2]), points(p[1] / p[2])
    direct = behind.any(-1)

    def edges(c, n):
        c = torch.where(behind, float("nan"), c)
        first = torch.floor(torch.clamp(c.nan_to_num(float("inf")).amin(-1), -4.0, n + 4.0))
        last = torch.floor(torch.clamp(c.nan_to_num(float("-inf")).amax(-1), -4.0, n + 4.0))
        c0 = torch.clamp(first.long() - 1, min=0)
        return c0, torch.clamp(torch.clamp(last.long() + 2, max=n - 1) - c0 + 1, min=0)

    x0, w = edges(x, W)
    y0, h = edges(y, H)
    direct = direct | (w * h > cap)
    w, h = torch.where(direct, 0, w), torch.where(direct, 0, h)
    return {"x0": x0, "y0": y0, "w": w, "h": h, "direct": direct}


def sweep_backward_counts(depths, M, Kt, H: int, W: int, C: int, tile_h: int, tile_w: int,
                          planes: int, cap: int) -> dict:
    """What the sweep backward kernel does under the box rule
    (`sweep_tap_box_plain`) with this work mapping: the tile groups on the
    shared and on the direct path, the valid samples of shared groups whose
    taps leave the box (they add to device memory directly), and the 16-byte
    global reductions (C / 4 per box pixel flushed, 4 C / 4 per sample added
    directly)."""
    B, D = M.shape[0], depths.shape[0]
    box = sweep_tap_box_plain(depths, M, Kt, H, W, tile_h, tile_w, planes, cap)
    x, y = sweep_pixel_coords(depths, M, Kt, H, W)                               # (B, D, H, W)
    valid, (yi, xi, yi1, xi1), _ = _taps(x, y, H, W)
    g = torch.arange(D, device=depths.device) // planes
    ty = torch.arange(H, device=depths.device) // tile_h
    tx = torch.arange(W, device=depths.device) // tile_w
    bi = torch.arange(B, device=depths.device)[:, None, None, None]
    at = (bi, ty[None, None, :, None], tx[None, None, None, :], g[None, :, None, None])
    x0, y0, w, h, direct = (box[k][at] for k in ("x0", "y0", "w", "h", "direct"))
    inside = (xi >= x0) & (xi1 < x0 + w) & (yi >= y0) & (yi1 < y0 + h)
    added = valid & (direct | ~inside)
    n_direct = int(box["direct"].sum())
    return {"shared_groups": box["direct"].numel() - n_direct, "direct_groups": n_direct,
            "left_box_samples": int((valid & ~direct & ~inside).sum()),
            "global_reductions": int((box["w"] * box["h"]).sum()) * (C // 4)
            + int(added.sum()) * C}


class PlaneSweepVolumeFn(torch.autograd.Function):
    """PSNet's cost volume with its gradients with respect to ref, tgt, M
    and K t.

    Forward: the sweep kernel on CUDA tensors, `plane_sweep_volume_plain` on
    CPU tensors. Backward, for what needs a gradient: the features' through
    the sweep backward kernel (`plane_sweep_volume_backward_plain` on CPU
    tensors), and the pose's, dM and dK t, through the sweep pose-gradient
    kernel (`plane_sweep_volume_pose_grad_plain` on CPU tensors), launched
    only when M or K t requires grad: PoseNet's pose does, the RANSAC pose
    is stop-gradient (JAX `models/sfmnet.py:297-300`). The plane depths get
    no gradient: the function raises if they require grad.
    """

    @staticmethod
    def forward(ctx, ref, tgt, depths, M, Kt):
        if ctx.needs_input_grad[2]:
            raise NotImplementedError("the plane sweep has no gradient with respect to "
                                      "its plane depths")
        ctx.save_for_backward(tgt if any(ctx.needs_input_grad[3:]) else None, depths, M, Kt)
        return _sweep_volume(ref, tgt, depths, M, Kt)

    @staticmethod
    def backward(ctx, dvol):
        tgt, depths, M, Kt = ctx.saved_tensors
        need_ref, need_tgt, _, need_M, need_Kt = ctx.needs_input_grad
        dvol = dvol.contiguous()
        dref = dtgt = dM = dKt = None
        kind = dvol.device.type
        if kind not in ("cuda", "cpu"):
            raise NotImplementedError(f"plane_sweep_volume backward on {kind}")
        if need_ref or need_tgt:
            if kind == "cuda":
                dref, dtgt = sweep_warp.plane_sweep_volume_backward_cuda(dvol, depths, M, Kt)
            else:
                dref, dtgt = plane_sweep_volume_backward_plain(dvol, depths, M, Kt)
        if need_M or need_Kt:
            if kind == "cuda":
                dM, dKt = sweep_warp.plane_sweep_volume_pose_grad_cuda(
                    dvol, tgt.contiguous(), depths, M, Kt)
            else:
                dM, dKt = plane_sweep_volume_pose_grad_plain(dvol, tgt, depths, M, Kt)
        return (dref if need_ref else None, dtgt if need_tgt else None, None,
                dM if need_M else None, dKt if need_Kt else None)


def _sweep_volume(ref, tgt, depths, M, Kt) -> torch.Tensor:
    if tgt.device.type == "cuda":
        return sweep_warp.plane_sweep_volume_cuda(ref.contiguous(), tgt.contiguous(),
                                                  depths.contiguous(), M, Kt)
    if tgt.device.type == "cpu":
        return plane_sweep_volume_plain(ref, tgt, depths, M, Kt)
    raise NotImplementedError(f"plane_sweep_volume on {tgt.device.type}")


def plane_sweep_volume(ref, tgt, depths, pose, K, K_inv) -> torch.Tensor:
    """PSNet's cost volume (B, D, H, W, 2C): [ref | tgt warped by `pose` onto
    each of the D fronto-parallel planes at `depths`], in the features' dtype.

    ref, tgt (B, H, W, C) f32 or bf16; depths (D,); pose (B, 3, 4) ref->target;
    K, K_inv (B, 3, 3); geometry in float32 (float64 for float64 features, which
    only the plain version takes). CUDA features go through the sweep
    kernel, CPU features through `plane_sweep_volume_plain`; where autograd
    tracks an input, through `PlaneSweepVolumeFn`, whose backward is the sweep
    backward kernel and, where the pose requires grad, the sweep
    pose-gradient kernel (plain on the CPU). The (B, 2C, D, H, W) view
    `.permute(0, 4, 1, 2, 3)` has channels-last-3d strides.
    """
    gdt = torch.promote_types(tgt.dtype, torch.float32)
    M, Kt = sweep_matrices(pose.to(gdt), K.to(gdt), K_inv.to(gdt))
    depths = depths.to(gdt)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (ref, tgt, depths, M, Kt)):
        return PlaneSweepVolumeFn.apply(ref, tgt, depths, M, Kt)
    return _sweep_volume(ref, tgt, depths, M, Kt)


# elements of a plain sweep correlation's per-chunk temporaries (a few
# float32 tensors of this size each): bounds the memory of a chunk of poses
_PLAIN_CHUNK_ELEMENTS = 1 << 26


def _pose_chunk(B: int, D: int, H: int, W: int, C: int) -> int:
    return max(1, _PLAIN_CHUNK_ELEMENTS // max(B * D * H * W * C, 1))


def _warp_poses(img, depths, M, Kt, s0: int, s1: int):
    """tgt warped by poses s0..s1 of M (B, S, 3, 3), Kt (B, S, 3): (B, s1 - s0,
    D, H, W, C) in img's dtype, by `sweep_pixel_coords` and
    `bilinear_sample_plain` (the sweep kernel's rule)."""
    B, H, W, C = img.shape
    n = s1 - s0
    x, y = sweep_pixel_coords(depths, M[:, s0:s1].reshape(-1, 3, 3),
                              Kt[:, s0:s1].reshape(-1, 3), H, W)       # (B n, D, H, W)
    warped = bilinear_sample_plain(img.repeat_interleave(n, dim=0), torch.stack([x, y], -1))
    return warped.reshape(B, n, *warped.shape[1:]), x, y


def sweep_correlation_plain(ref, tgt, depths, M, Kt) -> torch.Tensor:
    """Kernel K1's plain PyTorch version: REGNet's correlation
    mean(ref * warped, -1) over every pose hypothesis and plane depth (JAX
    `models/depth_alternates.py:248-252` of `_scaled_sweep`, `:91-107`).

    ref, tgt (B, H, W, C); depths (D,); M (B, S, 3, 3) = K R K^-1 and Kt
    (B, S, 3) = K t of the S poses of each batch item. Returns (B, S, D, H, W)
    in float32 (float64 for float64 features) with channels-last-3d strides
    (memory order (B, D, H, W, S)). The features are warped in that type (a
    bfloat16 map is read exactly, as the JAX module's float32 cast reads
    it); the channel sum runs c = 0..C-1 in order, then one divide by C,
    as the kernel's, so K1 agrees with this bit for bit. Poses go a chunk
    at a time, so memory stays bounded.
    """
    B, H, W, C = tgt.shape
    S, D = M.shape[1], depths.shape[0]
    cdt = torch.promote_types(tgt.dtype, torch.float32)
    img, refc = tgt.to(cdt), ref.to(cdt)[:, None, None]
    out = torch.empty((B, S, D, H, W), dtype=cdt, device=tgt.device,
                      memory_format=torch.channels_last_3d)
    step = _pose_chunk(B, D, H, W, C)
    for s0 in range(0, S, step):
        s1 = min(S, s0 + step)
        prod = refc * _warp_poses(img, depths, M, Kt, s0, s1)[0]     # (B, n, D, H, W, C)
        acc = prod[..., 0]
        for c in range(1, C):
            acc = acc + prod[..., c]
        out[:, s0:s1] = acc / C
    return out


def sweep_correlation_backward_plain(g, ref, tgt, depths, M, Kt):
    """Kernel K2's plain PyTorch version: the VJP of `sweep_correlation_plain`
    with respect to ref and tgt, as `jax.vjp` of the JAX composition gives
    it. With gc = g / C: dref = sum over poses and planes of gc warped; dtgt
    gathers, for every sample, gc ref times each tap's bilinear weight onto
    the four taps the forward read (`index_add_`). A sample the forward
    zeroed (out of the frame, or behind the camera) adds nothing.

    g (B, S, D, H, W), the correlation's gradient; the rest as the forward
    took them. Returns (dref, dtgt), each (B, H, W, C) in its map's dtype,
    summed in float32 (float64 for float64 features). Poses go a chunk at a
    time.
    """
    B, S, D, H, W = g.shape
    C = ref.shape[-1]
    cdt = torch.promote_types(tgt.dtype, torch.float32)
    gc = g.to(cdt) / C
    img, refc = tgt.to(cdt), ref.to(cdt)
    dref = torch.zeros((B, H, W, C), dtype=cdt, device=g.device)
    acc = torch.zeros((B * H * W, C), dtype=cdt, device=g.device)
    base = (torch.arange(B, device=g.device) * (H * W))[:, None]
    step = _pose_chunk(B, D, H, W, C)
    for s0 in range(0, S, step):
        s1 = min(S, s0 + step)
        warped, x, y = _warp_poses(img, depths, M, Kt, s0, s1)
        gs = gc[:, s0:s1, ..., None]                                  # (B, n, D, H, W, 1)
        dref += (gs * warped).sum(dim=(1, 2))
        # the forward's taps, from the float32 coordinates its gather reads
        valid, (yi, xi, yi1, xi1), (wx, wy) = _taps(x.reshape(B, -1).float(),
                                                    y.reshape(B, -1).float(), H, W)
        gw = (gs * refc[:, None, None]).reshape(B, -1, C) * valid[..., None].to(cdt)
        # 1 - w in float32, as the forward's blend rounds it; the products in cdt
        ax, ay, wx, wy = ((1 - wx).to(cdt), (1 - wy).to(cdt), wx.to(cdt), wy.to(cdt))
        for yy, xx, w in ((yi, xi, ay * ax), (yi, xi1, ay * wx),
                          (yi1, xi, wy * ax), (yi1, xi1, wy * wx)):
            acc.index_add_(0, (base + yy * W + xx).reshape(-1),
                           (gw * w[..., None]).reshape(-1, C))
    return dref.to(ref.dtype), acc.reshape(B, H, W, C).to(tgt.dtype)


class SweepCorrelationFn(torch.autograd.Function):
    """REGNet's sweep correlation with its gradient with respect to ref and
    tgt: kernel K1 forward and K2 backward on CUDA tensors, the plain versions
    on CPU tensors. The plane depths and the pose (M, K t) get no gradient:
    the function raises if they require one (REGNet under
    `pose.estimator=POSENET` in training; ROADMAP A.8d, K2's pose gradient).
    """

    @staticmethod
    def forward(ctx, ref, tgt, depths, M, Kt):
        if any(ctx.needs_input_grad[2:]):
            raise NotImplementedError(
                "the sweep correlation has no gradient with respect to its plane depths or "
                "the pose (M, K t): K2's pose gradient is not ported (ROADMAP A.8d)")
        ctx.save_for_backward(ref, tgt, depths, M, Kt)
        return _sweep_correlation(ref, tgt, depths, M, Kt)

    @staticmethod
    def backward(ctx, g):
        ref, tgt, depths, M, Kt = ctx.saved_tensors
        kind = g.device.type
        if kind == "cuda":
            dref, dtgt = sweep_corr.sweep_correlation_backward_cuda(
                g.contiguous(memory_format=torch.channels_last_3d), ref.contiguous(),
                tgt.contiguous(), depths.contiguous(), M.reshape(-1, 3, 3).contiguous(),
                Kt.reshape(-1, 3).contiguous())
        elif kind == "cpu":
            dref, dtgt = sweep_correlation_backward_plain(g, ref, tgt, depths, M, Kt)
        else:
            raise NotImplementedError(f"sweep_correlation backward on {kind}")
        needs = ctx.needs_input_grad
        return dref if needs[0] else None, dtgt if needs[1] else None, None, None, None


def _sweep_correlation(ref, tgt, depths, M, Kt) -> torch.Tensor:
    if tgt.device.type == "cuda":
        return sweep_corr.sweep_correlation_cuda(
            ref.contiguous(), tgt.contiguous(), depths.contiguous(),
            M.reshape(-1, 3, 3).contiguous(), Kt.reshape(-1, 3).contiguous())
    if tgt.device.type == "cpu":
        return sweep_correlation_plain(ref, tgt, depths, M, Kt)
    raise NotImplementedError(f"sweep_correlation on {tgt.device.type}")


def sweep_correlation(ref, tgt, depths, poses, K, K_inv) -> torch.Tensor:
    """REGNet's cost: corr[b, s, d] = mean over channels of ref times tgt
    warped by pose s of batch item b onto the fronto-parallel plane at depth
    d (JAX `mean(ref * _scaled_sweep(tgt, ...), -1)`, `models/
    depth_alternates.py:248-252`).

    ref, tgt (B, H, W, C) f32 or bf16 (float64 on the CPU only); depths (D,);
    poses (B, S, 3, 4) ref->target; K, K_inv (B, 3, 3), the features' scale.
    Returns (B, S, D, H, W) float32 (float64 for float64 features) with
    channels-last-3d strides, the layout REGNet's first Conv3d reads. CUDA
    features go through kernel K1, CPU features through
    `sweep_correlation_plain`; where autograd tracks a feature map, through
    `SweepCorrelationFn` (backward: K2, or its plain version on the CPU).
    """
    B, S = poses.shape[:2]
    gdt = torch.promote_types(tgt.dtype, torch.float32)
    M, Kt = sweep_matrices(poses.reshape(B * S, 3, 4).to(gdt),
                           K.to(gdt).repeat_interleave(S, dim=0),
                           K_inv.to(gdt).repeat_interleave(S, dim=0))
    M, Kt, depths = M.reshape(B, S, 3, 3), Kt.reshape(B, S, 3), depths.to(gdt)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (ref, tgt, depths, M, Kt)):
        return SweepCorrelationFn.apply(ref, tgt, depths, M, Kt)
    return _sweep_correlation(ref, tgt, depths, M, Kt)
