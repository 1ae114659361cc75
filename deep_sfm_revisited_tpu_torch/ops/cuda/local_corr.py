"""Kernel B2: the PWC-style windowed correlation, and PWC-DC's warp fused into it, as CUDA kernels for Hopper.

Both replace `deep_sfm_revisited_tpu/ops/pallas/local_corr.py::
local_correlation_pallas` (`pallas_call` at `:80`); the warped one also
replaces B1's gather (`ops/pallas/sweep_warp.py::bilinear_sample_pallas`)
on PWC-DC's flow warps. One source, `csrc/local_corr.cu`, built at first use
by `ops/cuda/build.py`; `csrc/local_corr_ops.cpp` registers its two entry
points as the PyTorch operators `torch.ops.dsfm_corr.*` (`OPS`), through
which each wrapper launches and adds one to its own count:

- `local_correlation_cuda` (`KERNEL.launches`): the windowed correlation.
  Plain version `ops/correlation.py::local_correlation_plain`;
  `ops/correlation.py::local_correlation` sends CUDA tensors here (PWC-DC's
  level 6).
- `warped_correlation_cuda` (`WARPED.launches`): the correlation of f1 with
  f2 sampled at q + scale flow(q) by B1's rule, with no warped map in device
  memory. Plain version `ops/correlation.py::warped_correlation_plain`;
  `ops/correlation.py::warped_correlation` sends CUDA tensors here (PWC-DC's
  levels 5..2).

The source's header says what bounds the kernels and how their design
answers that. `plan` picks the work mapping both take from the shape; it
needs no card, so the CPU tests reach it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel, TorchOps

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


def check_correlation_args(what: str, f0: torch.Tensor, f1: torch.Tensor, md: int,
                           f1_dtypes=(torch.float32,)) -> None:
    """Raise on what B2's kernels do not take: f0 not float32, f1 not of
    `f1_dtypes`, not one (B, H, W, C) shape with every size >= 1, not
    contiguous, md outside 1..4, a tensor not on CUDA or the two on two
    devices. Checked here, not only in the operators, so the CPU tests see
    every refusal."""
    if not (f0.is_cuda and f1.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors only")
    if f0.device != f1.device:
        raise ValueError(f"f0 on {f0.device}, f1 on {f1.device}")
    if f0.dtype != torch.float32 or f1.dtype not in f1_dtypes:
        raise TypeError(f"{what} dtypes {f0.dtype}, {f1.dtype}; takes float32 and "
                        f"{' or '.join(str(d) for d in f1_dtypes)}")
    if f0.dim() != 4 or f0.shape != f1.shape:
        raise ValueError(f"{what} shapes f0 {tuple(f0.shape)}, f1 {tuple(f1.shape)}")
    if not (f0.is_contiguous() and f1.is_contiguous()):
        raise ValueError(f"{what} takes contiguous NHWC f0 and f1")
    if not 1 <= md <= MAX_MD:
        raise ValueError(f"{what} max displacement {md}; takes 1..{MAX_MD}")
    if min(f0.shape) < 1:
        raise ValueError(f"{what} feature shape {tuple(f0.shape)} out of range")


class LocalCorrKernel(CudaKernel):
    """B2's library (plain C launchers, linked by `OPS`); launches the
    windowed correlation and owns its launch count."""

    source = "local_corr.cu"

    def __init__(self):
        super().__init__()
        self._op = None

    def _bind(self, lib) -> None:
        """Nothing to bind: the operators of `OPS` call the launchers."""

    def __call__(self, f0: torch.Tensor, f1: torch.Tensor, md: int) -> torch.Tensor:
        """f0, f1 (B, H, W, C) float32 -> (B, H, W, (2md+1)^2) float32."""
        check_correlation_args("B2", f0, f1, md)
        p = plan(*f0.shape, md)
        op = self._op
        if op is None:
            op = self._op = OPS.build().local_correlation.default
        out = op(f0, f1, md, p.px, p.cluster)
        self.launches += 1
        return out


class WarpedCorrelation:
    """Launches the warped correlation through `OPS`; owns its launch count."""

    def __init__(self):
        self.launches = 0
        self._op = None

    def __call__(self, f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor, scale: float,
                 md: int) -> torch.Tensor:
        """f1 (B, H, W, C) float32, f2 (B, H, W, C) float32 or bfloat16, flow
        (B, 2, H, W) float32, all contiguous on one device -> (B, H, W,
        (2md+1)^2) float32. It has no backward: inputs that need a gradient
        are refused while grad mode is on."""
        check_correlation_args("the warped correlation", f1, f2, md,
                               (torch.float32, torch.bfloat16))
        B, H, W, _ = f1.shape
        if flow.dtype != torch.float32 or tuple(flow.shape) != (B, 2, H, W) \
                or not flow.is_contiguous() or flow.device != f1.device:
            raise ValueError(f"the warped correlation's flow {tuple(flow.shape)} {flow.dtype} "
                             f"on {flow.device}; takes a contiguous float32 {(B, 2, H, W)} "
                             f"on {f1.device}")
        if torch.is_grad_enabled() and any(t.requires_grad for t in (f1, f2, flow)):
            raise NotImplementedError("the warped correlation has no backward")
        p = plan(*f1.shape, md)
        op = self._op
        if op is None:
            op = self._op = OPS.build().warped_correlation.default
        out = op(f1, f2, flow, float(scale), md, p.px, p.cluster)
        self.launches += 1
        return out


KERNEL = LocalCorrKernel()
OPS = TorchOps("local_corr_ops.cpp", KERNEL, "dsfm_corr")
BUILDS = (KERNEL, OPS)      # what chip_smoke.py's setup builds, in parallel with B1
WARPED = WarpedCorrelation()


def local_correlation_cuda(f0: torch.Tensor, f1: torch.Tensor, md: int) -> torch.Tensor:
    """Launch B2 on the current stream (see `LocalCorrKernel.__call__`)."""
    return KERNEL(f0, f1, md)


def warped_correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                            scale: float, md: int) -> torch.Tensor:
    """Launch the warped correlation on the current stream (see
    `WarpedCorrelation.__call__`)."""
    return WARPED(f1, f2, flow, scale, md)
