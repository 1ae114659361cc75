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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deep_sfm_revisited_tpu_torch.ops.camera import bilinear_sample_plain, pixel_grid
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


def local_correlation(f0: torch.Tensor, f1: torch.Tensor, md: int = 4) -> torch.Tensor:
    """Windowed correlation of f0, f1 (B, H, W, C) -> (B, H, W, (2md+1)^2).

    CUDA tensors go through kernel B2, which takes float32 (PWC-DC casts its
    features to float32 first, as the JAX network does); CPU tensors
    through `local_correlation_plain`.
    """
    if f0.device.type == "cuda":
        return local_corr.local_correlation_cuda(f0.contiguous(), f1.contiguous(), md)
    if f0.device.type == "cpu":
        return local_correlation_plain(f0, f1, md)
    raise NotImplementedError(f"local_correlation on {f0.device.type}")


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


def warped_correlation_nchw(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                            scale: float, md: int = 4) -> torch.Tensor:
    """PWC-DC's correlation of one warped level: f1, f2 (B, C, H, W) of the
    network's dtype, the up-sampled flow (B, 2, H, W) -> (B, (2md+1)^2, H,
    W) in f1's dtype, the correlation of f1 with f2 warped by flow * scale.

    CUDA tensors go through one launch of the warped correlation's kernel
    and nothing else: f1, f2 of one dtype and the flow, each float32 or
    bfloat16, f1 and f2 channels-last as PWC-DC's convolutions leave them
    (other layouts are refused, not copied); the output is channels-last
    too. CPU tensors go through `warped_correlation_nchw_plain`.
    """
    if f1.device.type == "cuda":
        return local_corr.warped_correlation_cuda(f1, f2, flow, scale, md)
    if f1.device.type == "cpu":
        return warped_correlation_nchw_plain(f1, f2, flow, scale, md)
    raise NotImplementedError(f"warped_correlation_nchw on {f1.device.type}")
