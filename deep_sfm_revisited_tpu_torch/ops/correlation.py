"""Windowed (PWC-style) correlation (port of `ops/correlation.py::local_correlation`).

`local_correlation` has a hand-written kernel: on CUDA tensors it launches
kernel B2 (`ops/cuda/local_corr.py`, source `csrc/local_corr.cu`); on CPU
tensors it runs `local_correlation_plain`, the kernel's plain PyTorch
version. There is no fallback from one to the other. Layout NHWC, as in
the JAX function. `epipolar_correlation` is not ported (no eval route
reaches it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
