"""Kernel B2: the PWC-style windowed correlation, as a CUDA kernel for Hopper.

Replaces `deep_sfm_revisited_tpu/ops/pallas/local_corr.py::
local_correlation_pallas` (`pallas_call` at `:80`). Its plain PyTorch
version is `ops/correlation.py::local_correlation_plain`;
`ops/correlation.py::local_correlation` sends CUDA tensors here and CPU
tensors there.

Source `csrc/local_corr.cu`, built at first use by `ops/cuda/build.py`. The
source's header says what bounds the kernel and how its design answers that.
`plan` picks the kernel's work mapping from the shape; it needs no card, so
the CPU tests reach it. `KERNEL.launches` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

MAX_MD = 4           # the source instantiates md = 1..4 (PWC-DC uses 4)
TILE_H = 4           # output rows per block (`kTileH`)
THREAD_COLS = 8      # thread columns per block (`kCols`)
PIXELS_PER_THREAD = (4, 2, 1)   # the source instantiates these PX
MAX_CLUSTER = 8      # `kMaxCluster`: the portable cluster size
TARGET_WARPS = 1024  # ~8 warps on each of the H100's 132 SMs


@dataclass(frozen=True)
class Plan:
    """B2's work mapping for one shape (see the header of `csrc/local_corr.cu`).

    A block covers `TILE_H` rows x `tile_w` columns of one image with one
    warp per displacement row (blockDim (8, 4, 2md+1)); each thread sums `px`
    adjacent pixels. `cluster` blocks along grid.x share one tile and split
    its channels, rank k taking `shares[k]` = [begin, end).
    """

    px: int
    cluster: int
    grid: tuple[int, int, int]
    block: tuple[int, int, int]
    shares: tuple[tuple[int, int], ...]

    @property
    def tile_w(self) -> int:
        return THREAD_COLS * self.px

    @property
    def warps(self) -> int:
        """Warps the launch puts on the card."""
        gx, gy, gz = self.grid
        return gx * gy * gz * self.block[2]


def channel_shares(C: int, cluster: int) -> tuple[tuple[int, int], ...]:
    """[begin, end) of each rank's channels: rank k takes the groups of 4
    [k G / n, (k+1) G / n) of G = ceil(C/4), as the kernel computes them."""
    groups = (C + 3) // 4
    return tuple((min(C, 4 * (k * groups // cluster)), min(C, 4 * ((k + 1) * groups // cluster)))
                 for k in range(cluster))


@functools.lru_cache(maxsize=256)
def plan(B: int, H: int, W: int, C: int, md: int) -> Plan:
    """The mapping B2 launches with for f0, f1 (B, H, W, C) and max displacement md.

    The launch should hold `TARGET_WARPS` warps. Pixels per thread start at
    the widest of 4, 2, 1 whose tiles overhang W by at most W/8, and narrow
    (more, smaller tiles) until the tiles alone reach the target; only where
    one pixel per thread still falls short does the cluster size double, up
    to 8 and while every rank keeps at least one group of 4 channels. On the
    H100 a channel split costs more than narrower tiles where both reach the
    target (the cluster's barriers and its reduction through distributed
    shared memory; `b2_compare.py --sweep`).
    """
    s = 2 * md + 1
    widths = [p for p in PIXELS_PER_THREAD
              if p == 1 or -(-W // (THREAD_COLS * p)) * THREAD_COLS * p - W <= W // 8]

    def tiles(p):
        return -(-W // (THREAD_COLS * p)), -(-H // TILE_H)

    px = next((p for p in widths if B * tiles(p)[0] * tiles(p)[1] * s >= TARGET_WARPS), 1)
    tiles_x, tiles_y = tiles(px)
    warps = B * tiles_x * tiles_y * s
    groups = (C + 3) // 4
    cluster = 1
    while cluster < MAX_CLUSTER and 2 * cluster <= groups and warps * cluster < TARGET_WARPS:
        cluster *= 2
    return Plan(px=px, cluster=cluster, grid=(tiles_x * cluster, tiles_y, B),
                block=(THREAD_COLS, TILE_H, s), shares=channel_shares(C, cluster))


class LocalCorrKernel(CudaKernel):
    """Builds, loads and launches B2; owns its launch count."""

    source = "local_corr.cu"

    def _bind(self, lib: ctypes.CDLL) -> None:
        fn = lib.dsfm_local_correlation
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       *[ctypes.c_int] * 7, ctypes.c_void_p]
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
        p = plan(B, H, W, C, md)
        out = torch.empty((B, H, W, (2 * md + 1) ** 2), dtype=torch.float32,
                          device=f0.device)
        lib = self.build()
        with torch.cuda.device(f0.device):
            stream = torch.cuda.current_stream(f0.device).cuda_stream
            err = lib.dsfm_local_correlation(f0.data_ptr(), f1.data_ptr(), out.data_ptr(),
                                             B, H, W, C, md, p.px, p.cluster, stream)
        if err != 0:
            raise RuntimeError(f"B2 launch failed: cudaError {err}")
        self.launches += 1
        return out


KERNEL = LocalCorrKernel()


def local_correlation_cuda(f0: torch.Tensor, f1: torch.Tensor, md: int) -> torch.Tensor:
    """Launch B2 on the current stream (see `LocalCorrKernel.__call__`)."""
    return KERNEL(f0, f1, md)
