"""Kernel B2: the PWC-style windowed correlation, as a CUDA kernel for Hopper.

Replaces `deep_sfm_revisited_tpu/ops/pallas/local_corr.py::
local_correlation_pallas` (`pallas_call` at `:80`). Its plain PyTorch
version is `ops/correlation.py::local_correlation_plain`;
`ops/correlation.py::local_correlation` sends CUDA tensors here and CPU
tensors there.

Source `csrc/local_corr.cu`, built at first use by `ops/cuda/build.py`. The
source's header says what bounds the kernel and how its design answers that.
`KERNEL.launches` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

MAX_MD = 4  # the source instantiates md = 1..4 (PWC-DC uses 4)


class LocalCorrKernel(CudaKernel):
    """Builds, loads and launches B2; owns its launch count."""

    source = "local_corr.cu"

    def _bind(self, lib: ctypes.CDLL) -> None:
        fn = lib.dsfm_local_correlation
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def __call__(self, f0: torch.Tensor, f1: torch.Tensor, md: int) -> torch.Tensor:
        """f0, f1 (B, H, W, C) float32 -> (B, H, W, (2md+1)^2) float32."""
        if not (f0.is_cuda and f1.is_cuda):
            raise ValueError("B2 takes CUDA tensors only")
        if f0.device != f1.device:
            raise ValueError(f"f0 on {f0.device}, f1 on {f1.device}")
        if f0.dtype != torch.float32 or f1.dtype != torch.float32:
            raise TypeError(f"B2 dtypes {f0.dtype}, {f1.dtype}; takes float32")
        if f0.dim() != 4 or f0.shape != f1.shape:
            raise ValueError(f"B2 shapes f0 {tuple(f0.shape)}, f1 {tuple(f1.shape)}")
        if not (f0.is_contiguous() and f1.is_contiguous()):
            raise ValueError("B2 takes contiguous NHWC f0 and f1")
        if not 1 <= md <= MAX_MD:
            raise ValueError(f"B2 max displacement {md}; takes 1..{MAX_MD}")
        B, H, W, C = f0.shape
        if min(B, H, W, C) < 1:
            raise ValueError(f"B2 feature shape {tuple(f0.shape)} out of range")
        out = torch.empty((B, H, W, (2 * md + 1) ** 2), dtype=torch.float32,
                          device=f0.device)
        lib = self.build()
        with torch.cuda.device(f0.device):
            stream = torch.cuda.current_stream(f0.device).cuda_stream
            err = lib.dsfm_local_correlation(f0.data_ptr(), f1.data_ptr(), out.data_ptr(),
                                             B, H, W, C, md, stream)
        if err != 0:
            raise RuntimeError(f"B2 launch failed: cudaError {err}")
        self.launches += 1
        return out


KERNEL = LocalCorrKernel()


def local_correlation_cuda(f0: torch.Tensor, f1: torch.Tensor, md: int) -> torch.Tensor:
    """Launch B2 on the current stream (see `LocalCorrKernel.__call__`)."""
    return KERNEL(f0, f1, md)
