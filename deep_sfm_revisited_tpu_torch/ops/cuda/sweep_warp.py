"""Kernel B1: the bilinear gather and the fused plane-sweep cost volume, in CUDA for Hopper.

Both replace `deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py::
bilinear_sample_pallas` (`pallas_call` at `:145`); the JAX package's PSNet
reaches it through `plane_sweep_warp_pallas` (`:169`). One source,
`csrc/sweep_warp.cu`, built at first use by `ops/cuda/build.py`, exports three
kernels, each with its own launch count:

- `bilinear_sample_cuda` (`KERNEL.launches`): the generic gather, for the
  flow warps. Plain version `ops/camera.py::bilinear_sample_plain`;
  `ops/camera.py::bilinear_sample` sends CUDA tensors here.
- `plane_sweep_volume_cuda` (`VOLUME.launches`): PSNet's whole
  (B, D, H, W, 2C) [ref | warped] volume, coordinates computed inline. Plain
  version `ops/camera.py::plane_sweep_volume_plain`;
  `ops/camera.py::plane_sweep_volume` sends CUDA tensors here.
- `plane_sweep_volume_backward_cuda` (`VOLUME_BACKWARD.launches`): the
  volume's gradient with respect to both feature maps. Plain version
  `ops/camera.py::plane_sweep_volume_backward_plain`;
  `ops/camera.py::PlaneSweepVolumeFn.backward` sends CUDA tensors here.

The source's header says what bounds each kernel and how its design answers
that.
"""

from __future__ import annotations

import ctypes

import torch

from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_BYTES = 16 * 256   # the sweep kernel: one 16-byte chunk per thread of a block


class SweepWarpKernel(CudaKernel):
    """Builds, loads and launches the generic gather; owns its launch count."""

    source = "sweep_warp.cu"

    def _bind(self, lib: ctypes.CDLL) -> None:
        fn = lib.dsfm_bilinear_sample
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for fn in (lib.dsfm_plane_sweep_volume, lib.dsfm_plane_sweep_volume_backward):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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


def _check_sweep_args(what: str, feats, depths: torch.Tensor, M: torch.Tensor,
                      Kt: torch.Tensor, B: int, C: int) -> None:
    """The sweep kernels' common rules: CUDA tensors on one device, contiguous;
    the feature tensors `feats` of one dtype, float32 or bfloat16, 16-byte
    aligned, with rows of C channels a multiple of 16 bytes up to
    `_MAX_ROW_BYTES`; depths (D,), M (B, 3, 3), Kt (B, 3) float32."""
    args = (*feats, depths, M, Kt)
    if not all(t.is_cuda for t in args):
        raise ValueError(f"the {what} takes CUDA tensors only")
    if any(t.device != args[0].device for t in args):
        raise ValueError(f"{what} inputs on {[str(t.device) for t in args]}")
    dtypes = {t.dtype for t in feats}
    if len(dtypes) != 1 or not dtypes <= set(_DTYPE_CODE):
        raise TypeError(f"{what} features {sorted(map(str, dtypes))}; takes one of "
                        "float32 or bfloat16 for all")
    if any(t.dtype != torch.float32 for t in (depths, M, Kt)):
        raise TypeError(f"{what} depths, M and Kt must be float32")
    if depths.dim() != 1 or M.shape != (B, 3, 3) or Kt.shape != (B, 3):
        raise ValueError(f"{what} depths {tuple(depths.shape)}, M {tuple(M.shape)}, "
                         f"Kt {tuple(Kt.shape)} for B = {B}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"the {what} takes contiguous inputs")
    row = C * feats[0].element_size()
    if row % 16 or row > _MAX_ROW_BYTES:
        raise ValueError(f"{what} feature rows of {row} bytes; takes a multiple of 16 "
                         f"up to {_MAX_ROW_BYTES}")
    if any(t.data_ptr() % 16 for t in feats) or any(t.data_ptr() % 4 for t in
                                                    (depths, M, Kt)):
        raise ValueError(f"{what} features must be 16-byte aligned, depths, M, Kt 4-byte")


class PlaneSweepVolume:
    """Launches the sweep kernel from `KERNEL`'s library; owns its launch count."""

    def __init__(self):
        self.launches = 0

    def __call__(self, ref: torch.Tensor, tgt: torch.Tensor, depths: torch.Tensor,
                 M: torch.Tensor, Kt: torch.Tensor) -> torch.Tensor:
        """ref, tgt (B, H, W, C) f32/bf16; depths (D,), M (B, 3, 3), Kt (B, 3)
        f32 -> (B, D, H, W, 2C) [ref | warped] in the features' dtype."""
        if ref.dim() != 4 or tgt.shape != ref.shape:
            raise ValueError(f"sweep shapes ref {tuple(ref.shape)}, tgt {tuple(tgt.shape)}")
        B, H, W, C = ref.shape
        _check_sweep_args("sweep kernel", (ref, tgt), depths, M, Kt, B, C)
        D = depths.shape[0]
        out = torch.empty((B, D, H, W, 2 * C), dtype=ref.dtype, device=ref.device)
        if out.numel() == 0:
            return out
        lib = KERNEL.build()
        with torch.cuda.device(ref.device):
            stream = torch.cuda.current_stream(ref.device).cuda_stream
            err = lib.dsfm_plane_sweep_volume(
                ref.data_ptr(), tgt.data_ptr(), depths.data_ptr(), M.data_ptr(),
                Kt.data_ptr(), out.data_ptr(), B, D, H, W, C, _DTYPE_CODE[ref.dtype], stream)
        if err != 0:
            raise RuntimeError(f"sweep kernel launch failed: cudaError {err}")
        self.launches += 1
        return out


class PlaneSweepVolumeBackward:
    """Launches the sweep's backward kernel from `KERNEL`'s library; owns its
    launch count."""

    def __init__(self):
        self.launches = 0

    def __call__(self, dvol: torch.Tensor, depths: torch.Tensor, M: torch.Tensor,
                 Kt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """dvol (B, D, H, W, 2C) f32/bf16, the volume's gradient; depths (D,),
        M (B, 3, 3), Kt (B, 3) f32 -> (dref, dtgt), each (B, H, W, C) in dvol's
        dtype. dtgt is summed in a float32 buffer, then cast."""
        if dvol.dim() != 5 or dvol.shape[-1] % 2 or dvol.shape[1] != depths.shape[0]:
            raise ValueError(f"sweep backward dvol {tuple(dvol.shape)}, "
                             f"depths {tuple(depths.shape)}")
        B, D, H, W, C2 = dvol.shape
        C = C2 // 2
        _check_sweep_args("sweep backward", (dvol,), depths, M, Kt, B, C)
        dref = torch.empty((B, H, W, C), dtype=dvol.dtype, device=dvol.device)
        acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=dvol.device)
        if dvol.numel() == 0:
            return dref.zero_(), acc.to(dvol.dtype)
        lib = KERNEL.build()
        with torch.cuda.device(dvol.device):
            stream = torch.cuda.current_stream(dvol.device).cuda_stream
            err = lib.dsfm_plane_sweep_volume_backward(
                dvol.data_ptr(), depths.data_ptr(), M.data_ptr(), Kt.data_ptr(),
                dref.data_ptr(), acc.data_ptr(), B, D, H, W, C, _DTYPE_CODE[dvol.dtype],
                stream)
        if err != 0:
            raise RuntimeError(f"sweep backward kernel launch failed: cudaError {err}")
        self.launches += 1
        return dref, acc.to(dvol.dtype)


KERNEL = SweepWarpKernel()
VOLUME = PlaneSweepVolume()
VOLUME_BACKWARD = PlaneSweepVolumeBackward()


def bilinear_sample_cuda(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Launch the generic gather on the current stream (see `SweepWarpKernel.__call__`)."""
    return KERNEL(img, coords)


def plane_sweep_volume_cuda(ref: torch.Tensor, tgt: torch.Tensor, depths: torch.Tensor,
                            M: torch.Tensor, Kt: torch.Tensor) -> torch.Tensor:
    """Launch the sweep kernel on the current stream (see `PlaneSweepVolume.__call__`)."""
    return VOLUME(ref, tgt, depths, M, Kt)


def plane_sweep_volume_backward_cuda(dvol: torch.Tensor, depths: torch.Tensor,
                                     M: torch.Tensor, Kt: torch.Tensor):
    """Launch the sweep's backward kernel on the current stream (see
    `PlaneSweepVolumeBackward.__call__`)."""
    return VOLUME_BACKWARD(dvol, depths, M, Kt)
