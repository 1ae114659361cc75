"""Kernel B1: the bilinear gather, as a CUDA kernel for Hopper.

Replaces `deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py::
bilinear_sample_pallas` (`pallas_call` at `:145`). Its plain PyTorch version
is `ops/camera.py::bilinear_sample_plain`; `ops/camera.py::bilinear_sample`
sends CUDA tensors here and CPU tensors there.

Source `csrc/sweep_warp.cu`, built at first use by `ops/cuda/build.py`. The
source's header says what bounds the kernel and how its design answers that.
`KERNEL.launches` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class SweepWarpKernel(CudaKernel):
    """Builds, loads and launches B1; owns its launch count."""

    source = "sweep_warp.cu"

    def _bind(self, lib: ctypes.CDLL) -> None:
        fn = lib.dsfm_bilinear_sample
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def __call__(self, img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, C) f32/bf16, coords (B, ..., 2) f32 -> (B, ..., C)."""
        if not (img.is_cuda and coords.is_cuda):
            raise ValueError("B1 takes CUDA tensors only")
        if img.device != coords.device:
            raise ValueError(f"img on {img.device}, coords on {coords.device}")
        if img.dtype not in _DTYPE_CODE:
            raise TypeError(f"B1 image dtype {img.dtype}; takes float32 or bfloat16")
        if coords.dtype != torch.float32:
            raise TypeError(f"B1 coords dtype {coords.dtype}; takes float32")
        if img.dim() != 4 or coords.dim() < 2 or coords.shape[-1] != 2 \
                or coords.shape[0] != img.shape[0]:
            raise ValueError(f"B1 shapes img {tuple(img.shape)}, "
                             f"coords {tuple(coords.shape)}")
        if not (img.is_contiguous() and coords.is_contiguous()):
            raise ValueError("B1 takes contiguous img and coords")
        if coords.data_ptr() % 8:
            raise ValueError("B1 coords must be 8-byte aligned")
        B, H, W, C = img.shape
        if min(B, H, W, C) < 1:
            raise ValueError(f"B1 image shape {tuple(img.shape)} out of range")
        out = torch.empty(coords.shape[:-1] + (C,), dtype=img.dtype,
                          device=img.device)
        Q = out.numel() // (B * C)
        if Q == 0:
            return out
        vec_elems = 16 // img.element_size()
        vector = int(C % vec_elems == 0 and img.data_ptr() % 16 == 0
                     and out.data_ptr() % 16 == 0)
        lib = self.build()
        with torch.cuda.device(img.device):
            stream = torch.cuda.current_stream(img.device).cuda_stream
            err = lib.dsfm_bilinear_sample(
                img.data_ptr(), coords.data_ptr(), out.data_ptr(),
                B, H, W, C, Q, _DTYPE_CODE[img.dtype], vector, stream)
        if err != 0:
            raise RuntimeError(f"B1 launch failed: cudaError {err}")
        self.launches += 1
        return out


KERNEL = SweepWarpKernel()


def bilinear_sample_cuda(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Launch B1 on the current stream (see `SweepWarpKernel.__call__`)."""
    return KERNEL(img, coords)
