"""Kernels R1 and R2: RAFT's correlation lookup and its backward, as CUDA
kernels for Hopper.

They replace no Pallas kernel: the JAX package computes the lookup
(`deep_sfm_revisited_tpu/models/raft.py::lookup_correlation`, `:127-181`) as
XLA one-hot matmuls and its gradient as their transposes. One source,
`csrc/raft_lookup.cu`, built at first use by `ops/cuda/build.py`;
`csrc/raft_lookup_ops.cpp` registers its entry points as the PyTorch
operators `torch.ops.dsfm_raft.*` (`OPS`), through which each wrapper
launches and adds one to its own count:

- `raft_lookup_cuda` (`LOOKUP.launches`): the (2r+1)^2 window of every
  pyramid level around each query's coordinates, one launch over all
  levels. Plain version `models/raft.py::lookup_correlation_plain`.
- `raft_lookup_backward_cuda` (`LOOKUP_BACKWARD.launches`): the gradients
  of the levels (dense, in their dtype) and of the coordinates (float32).
  Plain version `models/raft.py::lookup_correlation_backward_plain`.

`models/raft.py::RaftLookupFn` sends CUDA tensors here, and CPU tensors to
the plain versions. `mapping` is the kernels' launch geometry and
`grad_row_units` their dense write's split, which the CPU tests replay.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel, TorchOps

MAX_LEVELS = 4       # `kMaxLevels`: warps a block
MAX_RADIUS = 4       # the source instantiates radius 1..4 (RAFT uses 4)
WARP = 32


@dataclass(frozen=True)
class Mapping:
    """R1's and R2's launch geometry (see the header of `csrc/raft_lookup.cu`):
    one block a query (grid.x = Q) with one warp a level (blockDim (32, L)).
    In R1 and R2 lane j of warp l stages the patch taps j, j+32, ... of
    level l and takes its window channels j, j+32, ...; in R2 the block's
    32 L threads then write every level's row (`grad_row_units`)."""

    grid: int
    block: tuple[int, int]
    patch: int        # taps a (query, level): (2r+2)^2
    channels: int     # window channels a level: (2r+1)^2

    def lane_items(self, lane: int, n: int) -> range:
        """The items (taps or channels) of `n` that a lane takes."""
        return range(lane, n, WARP)


def mapping(Q: int, levels: int, radius: int) -> Mapping:
    return Mapping(grid=Q, block=(WARP, levels), patch=(2 * radius + 2) ** 2,
                   channels=(2 * radius + 1) ** 2)


def grad_row_units(n: int, itemsize: int, tid: int, nthreads: int,
                   aligned: bool = True) -> list[tuple[int, int]]:
    """The [begin, end) element runs of a level's gradient row of `n`
    elements that thread `tid` of `nthreads` writes in R2: 16-byte units
    u = tid, tid + nthreads, ... where the row is a whole number of them
    (and its address 16-byte aligned), else single elements."""
    v = 16 // itemsize
    if n % v == 0 and aligned:
        return [(u * v, u * v + v) for u in range(tid, n // v, nthreads)]
    return [(e, e + 1) for e in range(tid, n, nthreads)]


def check_lookup_args(what: str, coords: torch.Tensor, levels: Sequence[torch.Tensor],
                      radius: int) -> None:
    """Raise on what R1 and R2 do not take: coords not (B, h, w, 2) float32
    contiguous on a card; not 1..4 levels; a level not (B h w, Hl, Wl)
    contiguous, of another dtype than the first, not float32 or bfloat16,
    or on another device; radius outside 1..4. Checked here before the
    operators check again, so a refusal names the Python-side cause."""
    if not coords.is_cuda or not all(t.is_cuda for t in levels):
        raise ValueError(f"{what} takes CUDA tensors only")
    if coords.dtype != torch.float32:
        raise TypeError(f"{what} coords dtype {coords.dtype}; takes float32")
    if coords.dim() != 4 or coords.shape[-1] != 2 or not coords.is_contiguous():
        raise ValueError(f"{what} takes contiguous coords (B, h, w, 2); got "
                         f"{tuple(coords.shape)}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{what} takes 1..{MAX_LEVELS} levels; got {len(levels)}")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"{what} radius {radius}; takes 1..{MAX_RADIUS}")
    Q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    dtype = levels[0].dtype
    for i, t in enumerate(levels):
        if t.device != coords.device:
            raise ValueError(f"{what} level {i} on {t.device}, coords on {coords.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != dtype:
            raise TypeError(f"{what} level {i} dtype {t.dtype}; takes one dtype, float32 or "
                            "bfloat16")
        if t.dim() != 3 or t.shape[0] != Q or min(t.shape) < 1 or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous levels ({Q}, Hl, Wl); level {i} "
                             f"{tuple(t.shape)}")


class RaftLookupKernel(CudaKernel):
    """R1's and R2's library (plain C launchers, linked by `OPS`); launches
    R1 and owns its launch count."""

    source = "raft_lookup.cu"

    def __init__(self):
        super().__init__()
        self._op = None

    def _bind(self, lib) -> None:
        """Nothing to bind: the operators of `OPS` call the launchers."""

    def __call__(self, coords: torch.Tensor, levels: Sequence[torch.Tensor], radius: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
        """coords (B, h, w, 2) float32, levels (B h w, Hl, Wl) of one dtype
        (float32 or bfloat16) -> (B, h, w, L (2r+1)^2) in `out_dtype`
        (float32 or bfloat16), channels dx-major within each level."""
        check_lookup_args("R1", coords, levels, radius)
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"R1 out dtype {out_dtype}; takes float32 or bfloat16")
        op = self._op
        if op is None:
            op = self._op = OPS.build().raft_lookup.default
        out = op(coords, list(levels), radius, out_dtype)
        self.launches += 1
        return out


class RaftLookupBackward:
    """Launches R2 through `OPS`; owns its launch count."""

    def __init__(self):
        self.launches = 0
        self._op = None

    def __call__(self, coords: torch.Tensor, levels: Sequence[torch.Tensor], dout: torch.Tensor,
                 radius: int) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """coords and levels as R1 took them, dout (B, h, w, L (2r+1)^2)
        float32 or bfloat16 -> (d coords (B, h, w, 2) float32, [d level]
        each of its level's shape and dtype)."""
        check_lookup_args("R2", coords, levels, radius)
        want = (*coords.shape[:3], len(levels) * (2 * radius + 1) ** 2)
        if (dout.device != coords.device or dout.dtype not in (torch.float32, torch.bfloat16)
                or tuple(dout.shape) != want):
            raise ValueError(f"R2 takes a float32 or bfloat16 dout {want} on {coords.device}; "
                             f"got {dout.dtype} {tuple(dout.shape)} on {dout.device}")
        op = self._op
        if op is None:
            op = self._op = OPS.build().raft_lookup_backward.default
        dcoords, *dlevels = op(coords, list(levels), dout.contiguous(), radius)
        self.launches += 1
        return dcoords, dlevels


LOOKUP = RaftLookupKernel()
LOOKUP_BACKWARD = RaftLookupBackward()
OPS = TorchOps("raft_lookup_ops.cpp", (LOOKUP,), "dsfm_raft")
BUILDS = (LOOKUP, OPS)   # what chip_smoke.py's setup builds, with B1 and B2


def raft_lookup_cuda(coords: torch.Tensor, levels: Sequence[torch.Tensor], radius: int,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch R1 on the current stream (see `RaftLookupKernel.__call__`)."""
    return LOOKUP(coords, levels, radius, out_dtype)


def raft_lookup_backward_cuda(coords: torch.Tensor, levels: Sequence[torch.Tensor],
                              dout: torch.Tensor, radius: int):
    """Launch R2 on the current stream (see `RaftLookupBackward.__call__`)."""
    return LOOKUP_BACKWARD(coords, levels, dout, radius)

