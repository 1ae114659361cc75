"""Windowed (PWC-style) correlation (port of `ops/correlation.py::local_correlation`).

`local_correlation` has a hand-written kernel: on CUDA tensors it launches
kernel B2 (`ops/cuda/local_corr.py`, source `csrc/local_corr.cu`); on CPU
tensors it runs `local_correlation_plain`, the kernel's plain PyTorch
version. Layout NHWC, as in the JAX function.

`warped_correlation_nchw` is PWC-DC's flow warp and correlation of one
level (JAX `models/pwcnet.py:125-131`, the correlation cast back to the
network's dtype) in PWC-DC's layout and dtype (NCHW tensors, channels-last
in memory as its convolutions hold them): one kernel on CUDA tensors
(`csrc/warped_corr.cu`), `warped_correlation_nchw_plain` on CPU tensors.
`warped_correlation` is the same function under JAX's NHWC contract (on
CUDA the kernel between permutes, float32 features only; used by tests
only), with `warped_correlation_plain`. There is no fallback from a kernel to its plain
version. `epipolar_correlation` is not ported (no eval route reaches it).

Gradients: `local_correlation` and `warped_correlation_nchw` go through
autograd functions (`LocalCorrelationFn`, `WarpedCorrelationFn`) whose
backward is a kernel too on CUDA tensors (`csrc/warped_corr_backward.cu`)
and, on CPU tensors, the explicit formulas of
`local_correlation_backward_plain` and
`warped_correlation_nchw_backward_plain`, the kernels' plain versions: the
CPU and the card share one gradient rule, JAX's (`jax.vjp` of its
`local_correlation`, and of `warp_flow` then `local_correlation`), which
the CPU tests hold them to. Autograd of the plain forwards is a test
yardstick only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from deep_sfm_revisited_tpu_torch.ops.camera import _taps, bilinear_sample_plain, pixel_grid
from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr


def local_correlation_plain(f0: torch.Tensor, f1: torch.Tensor, md: int = 4) -> torch.Tensor:
    """Kernel B2's plain PyTorch version (JAX `local_correlation`, `:28-44`).

    f0, f1 (B, H, W, C) -> (B, H, W, (2md+1)^2) in their dtype: channel
    (dy+md)*(2md+1) + (dx+md) holds sum_c f0[y, x] f1[y+dy, x+dx] / C, zero
    where (y+dy, x+dx) lies outside the frame.
    """
    B, H, W, C = f0.shape
    f1p = F.pad(f1, (0, 0, md, md, md, md))
    outs = []
    for dy in range(-md, md + 1):
        for dx in range(-md, md + 1):
            shifted = f1p[:, dy + md:dy + md + H, dx + md:dx + md + W]
            outs.append(torch.sum(f0 * shifted, dim=-1))
    return torch.stack(outs, dim=-1) / C


def _correlation_vjp(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, md: int):
    """The VJP of `local_correlation_plain` at a, b (B, H, W, C) for the
    gradient g (B, H, W, (2md+1)^2), all of one dtype, in that dtype:
    (sum_d g[p, d] b[p + d] / C, sum_d g[q - d, d] a[q - d] / C), each sum
    in displacement order and divided by C once."""
    B, H, W, C = a.shape
    S = 2 * md + 1
    bp = F.pad(b, (0, 0, md, md, md, md))
    da = torch.zeros_like(a)
    dbp = torch.zeros_like(bp)
    for dy in range(S):
        for dx in range(S):
            gk = g[..., dy * S + dx, None]
            da += gk * bp[:, dy:dy + H, dx:dx + W]
            dbp[:, dy:dy + H, dx:dx + W] += gk * a
    return da / C, dbp[:, md:md + H, md:md + W] / C


def local_correlation_backward_plain(f0: torch.Tensor, f1: torch.Tensor, dout: torch.Tensor,
                                     md: int = 4):
    """B2's backward's plain PyTorch version: the explicit VJP of
    `local_correlation_plain` (JAX's `jax.vjp` of `local_correlation`).

    f0, f1 (B, H, W, C), dout (B, H, W, (2md+1)^2) -> (d f0, d f1) in f0's
    and f1's dtypes:
        d f0[p] = sum_d dout[p, d] f1[p + d] / C,
        d f1[q] = sum_d dout[q - d, d] f0[q - d] / C,
    where the terms whose p + d or q - d leaves the frame are absent;
    summed in float32 (float64 for float64 inputs) and divided by C once.
    """
    cdt = torch.promote_types(torch.promote_types(f0.dtype, f1.dtype), torch.float32)
    d0, d1 = _correlation_vjp(f0.to(cdt), f1.to(cdt), dout.to(cdt), md)
    return d0.to(f0.dtype), d1.to(f1.dtype)


class LocalCorrelationFn(torch.autograd.Function):
    """The windowed correlation and its gradient: kernel B2 and its backward
    kernel on CUDA tensors, `local_correlation_plain` and
    `local_correlation_backward_plain` on CPU tensors. An input that needs
    no gradient gets None."""

    @staticmethod
    def forward(ctx, f0, f1, md):
        ctx.md = md
        if f0.device.type == "cuda":
            f0, f1 = f0.contiguous(), f1.contiguous()
            out = local_corr.local_correlation_cuda(f0, f1, md)
        else:
            out = local_correlation_plain(f0, f1, md)
        ctx.save_for_backward(f0, f1)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        f0, f1 = ctx.saved_tensors
        if dout.device.type == "cuda":
            d0, d1 = local_corr.local_correlation_backward_cuda(f0, f1, dout.contiguous(), ctx.md)
        else:
            d0, d1 = local_correlation_backward_plain(f0, f1, dout, ctx.md)
        need0, need1, _ = ctx.needs_input_grad
        return d0 if need0 else None, d1 if need1 else None, None


def local_correlation(f0: torch.Tensor, f1: torch.Tensor, md: int = 4) -> torch.Tensor:
    """Windowed correlation of f0, f1 (B, H, W, C) -> (B, H, W, (2md+1)^2),
    differentiable in f0 and f1 (`LocalCorrelationFn`).

    CUDA tensors go through kernel B2 and its backward kernel, which take
    float32 (PWC-DC casts its features to float32 first, as the JAX network
    does); CPU tensors through `local_correlation_plain` and
    `local_correlation_backward_plain`.
    """
    if f0.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"local_correlation on {f0.device.type}")
    return LocalCorrelationFn.apply(f0, f1, md)


def warped_correlation_plain(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                             scale: float, md: int = 4) -> torch.Tensor:
    """The warped correlation's plain PyTorch version.

    f1, f2 (B, H, W, C), flow (B, 2, H, W) -> (B, H, W, (2md+1)^2) float32:
    `local_correlation_plain` of f1 and of f2 warped by flow * scale (B1's
    gather's plain version at grid + flow * scale, in f2's dtype), both cast
    to float32, as PWC-DC's `warp_flow` and correlation compute them.
    """
    B, H, W, C = f2.shape
    grid = pixel_grid(H, W, torch.float32, f2.device)[:2]            # (2, H, W): x, y
    coords = (grid[None] + flow.float() * scale).permute(0, 2, 3, 1)  # (B, H, W, 2)
    warped = bilinear_sample_plain(f2, coords)
    return local_correlation_plain(f1.float(), warped.float(), md)


def warped_correlation(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor, scale: float,
                       md: int = 4) -> torch.Tensor:
    """Correlation of f1 (B, H, W, C) float32 with f2 (B, H, W, C) warped by
    flow (B, 2, H, W) * scale -> (B, H, W, (2md+1)^2) float32.

    CUDA tensors go through the warped correlation's kernel between
    permutes, and there f2 is float32 too (bfloat16 features take
    `warped_correlation_nchw`, in whose dtype the kernel computes); CPU
    tensors through `warped_correlation_plain`, f2 of any float dtype.
    """
    if f1.device.type == "cuda":
        if f1.dtype != torch.float32 or f2.dtype != torch.float32:
            raise TypeError(f"warped_correlation on CUDA takes float32 f1 and f2, not "
                            f"{f1.dtype}, {f2.dtype}; bfloat16 features take "
                            "warped_correlation_nchw")
        out = local_corr.warped_correlation_cuda(
            f1.contiguous().permute(0, 3, 1, 2), f2.contiguous().permute(0, 3, 1, 2),
            flow.float(), scale, md)
        return out.permute(0, 2, 3, 1)
    if f1.device.type == "cpu":
        return warped_correlation_plain(f1, f2, flow, scale, md)
    raise NotImplementedError(f"warped_correlation on {f1.device.type}")


def warped_correlation_nchw_plain(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                                  scale: float, md: int = 4) -> torch.Tensor:
    """The warped correlation kernel's plain PyTorch version in PWC-DC's
    layout: f1, f2 (B, C, H, W), flow (B, 2, H, W) -> (B, (2md+1)^2, H, W)
    in f1's dtype, channels-last as the kernel writes it:
    `warped_correlation_plain` between permutes, cast back."""
    corr = warped_correlation_plain(f1.permute(0, 2, 3, 1), f2.permute(0, 2, 3, 1), flow,
                                    scale, md)
    return corr.permute(0, 3, 1, 2).to(f1.dtype)


def warped_correlation_nchw_backward_plain(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                                           scale: float, dout: torch.Tensor, md: int = 4):
    """The warped correlation's backward kernel's plain PyTorch version: the
    explicit VJP of `warped_correlation_nchw_plain` in f1, f2 and the flow,
    as `jax.vjp` of JAX's `warp_flow` then `local_correlation` gives it.

    f1, f2 (B, C, H, W), flow (B, 2, H, W), dout (B, (2md+1)^2, H, W) ->
    (d f1, d f2) channels-last in f1's and f2's dtypes and d flow (B, 2, H,
    W) in the flow's dtype. With w the forward's warped f2 (B1's rule at
    q + scale flow(q), in f2's dtype), float32 (float64 for float64
    features) throughout:
    - d f1 and d w are the correlation's VJP (`_correlation_vjp`); d w is
      kept at that precision, not rounded to f2's dtype as autograd of a
      bfloat16 chain (and JAX's) rounds it;
    - d f2 scatters d w times each tap's bilinear weight ((d w (1 - wy))
      (1 - wx) onto tap (0, 0) and so on) onto the sample's four taps
      (`index_add_`);
    - d flow[q] = scale (gx, gy), gx = sum_c d w[q, c] ((v01 - v00)(1 - wy)
      + (v11 - v10) wy) and gy = sum_c d w[q, c] ((v10 - v00)(1 - wx) +
      (v11 - v01) wx), with a +1 tap beyond the frame read as zero (JAX's
      zero pad) and each halved where the float32 coordinate lies exactly on
      the first or last column (row): the JAX gradient of its clip at a tie.
      It is zero where the sample is off the frame, and float32 as the
      coordinates are (for float64 features too: JAX computes the
      coordinates' gradient in float32 whatever the features' dtype).
    """
    B, C, H, W = f1.shape
    cdt = torch.promote_types(torch.promote_types(f1.dtype, f2.dtype), torch.float32)
    f1n, f2n = f1.permute(0, 2, 3, 1), f2.permute(0, 2, 3, 1)
    grid = pixel_grid(H, W, torch.float32, f2.device)[:2]
    coords = (grid[None] + flow.float() * scale).permute(0, 2, 3, 1).reshape(B, -1, 2)
    x, y = coords[..., 0], coords[..., 1]
    valid, (yi, xi, yi1, xi1), (wx, wy) = _taps(x, y, H, W)
    flat = f2n.reshape(B, H * W, C).to(cdt)

    def tap(yy, xx):
        return torch.gather(flat, 1, (yy * W + xx)[..., None].expand(-1, -1, C))

    v00, v01, v10, v11 = tap(yi, xi), tap(yi, xi1), tap(yi1, xi), tap(yi1, xi1)
    # the weights as the forward's gather forms them (float32), then widened
    ax, ay = (1 - wx).to(cdt)[..., None], (1 - wy).to(cdt)[..., None]
    bx, by = wx.to(cdt)[..., None], wy.to(cdt)[..., None]
    vmask = valid[..., None].to(cdt)
    warped = (((v00 * ax + v01 * bx) * ay + (v10 * ax + v11 * bx) * by) * vmask).to(f2.dtype)
    d1, dw = _correlation_vjp(f1n.to(cdt), warped.reshape(B, H, W, C).to(cdt),
                              dout.permute(0, 2, 3, 1).to(cdt), md)
    dw = dw.reshape(B, H * W, C)

    top, bot = dw * vmask * ay, dw * vmask * by
    base = (torch.arange(B, device=f2.device) * (H * W))[:, None]
    acc = torch.zeros((B * H * W, C), dtype=cdt, device=f2.device)
    for yy, xx, part in ((yi, xi, top * ax), (yi, xi1, top * bx), (yi1, xi, bot * ax),
                         (yi1, xi1, bot * bx)):
        acc.index_add_(0, (base + yy * W + xx).reshape(-1), part.reshape(-1, C))

    hx = (xi + 1 < W).to(cdt)[..., None]
    hy = (yi + 1 < H).to(cdt)[..., None]
    z01, z10, z11 = v01 * hx, v10 * hy, v11 * (hx * hy)
    gx = torch.sum(dw * ((z01 - v00) * ay + (z11 - z10) * by), dim=-1).float()
    gy = torch.sum(dw * ((z10 - v00) * ax + (z11 - z01) * bx), dim=-1).float()
    half = torch.tensor(0.5, device=f2.device)
    ex = torch.where(x == 0, half, 1.0) * torch.where(x == W - 1, half, 1.0)
    ey = torch.where(y == 0, half, 1.0) * torch.where(y == H - 1, half, 1.0)
    gx = torch.where(valid, gx * ex, 0.0) * scale
    gy = torch.where(valid, gy * ey, 0.0) * scale
    dflow = torch.stack([gx, gy], dim=1).reshape(B, 2, H, W).to(flow.dtype)
    df1 = d1.to(f1.dtype).permute(0, 3, 1, 2)
    df2 = acc.reshape(B, H, W, C).to(f2.dtype).permute(0, 3, 1, 2)
    return df1, df2, dflow


class WarpedCorrelationFn(torch.autograd.Function):
    """PWC-DC's warped correlation of one level and its gradient: the
    warped correlation's kernel and its backward kernel on CUDA tensors,
    `warped_correlation_nchw_plain` and
    `warped_correlation_nchw_backward_plain` on CPU tensors. An input that
    needs no gradient gets None."""

    @staticmethod
    def forward(ctx, f1, f2, flow, scale, md):
        ctx.scale, ctx.md = scale, md
        ctx.save_for_backward(f1, f2, flow)
        if f1.device.type == "cuda":
            return local_corr.warped_correlation_cuda(f1, f2, flow, scale, md)
        return warped_correlation_nchw_plain(f1, f2, flow, scale, md)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        f1, f2, flow = ctx.saved_tensors
        if dout.device.type == "cuda":
            grads = local_corr.warped_correlation_backward_cuda(f1, f2, flow, ctx.scale, dout,
                                                                ctx.md)
        else:
            grads = warped_correlation_nchw_backward_plain(f1, f2, flow, ctx.scale, dout, ctx.md)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def warped_correlation_nchw(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                            scale: float, md: int = 4) -> torch.Tensor:
    """PWC-DC's correlation of one warped level: f1, f2 (B, C, H, W) of the
    network's dtype, the up-sampled flow (B, 2, H, W) -> (B, (2md+1)^2, H,
    W) in f1's dtype, the correlation of f1 with f2 warped by flow * scale,
    differentiable in f1, f2 and the flow (`WarpedCorrelationFn`).

    CUDA tensors go through one launch of the warped correlation's kernel
    and nothing else (its backward through one launch of the backward
    kernel, and in bfloat16 a cast): f1, f2 of one dtype and the flow, each
    float32 or bfloat16, f1 and f2 channels-last as PWC-DC's convolutions
    leave them (other layouts are refused, not copied); the output and the
    features' gradients are channels-last too. CPU tensors go through
    `warped_correlation_nchw_plain` and its backward's plain version.
    """
    if f1.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"warped_correlation_nchw on {f1.device.type}")
    return WarpedCorrelationFn.apply(f1, f2, flow, scale, md)
