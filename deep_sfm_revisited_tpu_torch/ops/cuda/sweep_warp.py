"""Kernel B1: the bilinear gather, as a CUDA kernel for Hopper.

Replaces `deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py::
bilinear_sample_pallas` (`pallas_call` at `:145`). Its plain PyTorch version
is `ops/camera.py::bilinear_sample_plain`; `ops/camera.py::bilinear_sample`
sends CUDA tensors here and CPU tensors there.

Source `csrc/sweep_warp.cu`, built at first use with `nvcc` for `sm_90a`
into `_build/` (a shared library with a plain C interface, loaded with
ctypes), so nothing but the CUDA toolkit is needed. The source's header says
what bounds the kernel and how its design answers that.

`KERNEL.launches` counts launches: the wrapper adds one right after each
launch and nowhere else, so a run can prove that its main path went through
the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "sweep_warp.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class SweepWarpKernel:
    """Builds, loads and launches B1; owns its launch count."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> ctypes.CDLL:
        """Compile (once per source content) and load the shared library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
            lib_path = BUILD_DIR / f"libsweep_warp_{digest}.so"
            if not lib_path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True,
                )
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {SOURCE}:\n{self.build_log}")
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            fn = lib.dsfm_bilinear_sample
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib = lib
            return lib

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
