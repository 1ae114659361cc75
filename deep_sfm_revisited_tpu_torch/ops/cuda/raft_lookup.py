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
- `raft_lookup_backward_cuda` (`LOOKUP_BACKWARD.launches`): adds the
  levels' gradients into one accumulator a level (in their dtype, zero-filled
  once a backward pass by the caller: RAFT's iterations add into one pyramid
  gradient) and returns the coordinates' gradient (float32). Plain version
  `models/raft.py::lookup_correlation_backward_accumulate_plain`.

`models/raft.py::RaftLookupFn` sends CUDA tensors here, and CPU tensors to
the plain versions. `R1_QUERIES` and `R2_QUERIES` are the kernels'
queries a block; `row_word`, `row_words`, `unpack_row`, `owned_word`,
`word_mode` and `store_units` are their index arithmetic in Python, which
the CPU tests replay.
"""

from __future__ import annotations

from typing import Sequence

import torch

from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel, TorchOps

MAX_LEVELS = 4       # `kMaxLevels`
MAX_RADIUS = 4       # the source instantiates radius 1..4 (RAFT uses 4)
# queries a block: the source's `kR1Queries` and `kR2Queries`, chosen by
# timing 4, 8, 16 and 2, 4, 8 on the card (`raft_compare.py`)
R1_QUERIES, R2_QUERIES = 4, 2


def threads_a_query(radius: int, backward: bool = False) -> int:
    """R1: one thread a window row (2r+1) of each level; R2: one a patch row
    (2r+2) of each level (`kMaxLevels` levels, those beyond L idle)."""
    return MAX_LEVELS * (2 * radius + (2 if backward else 1))


def row_word(base: int, y: int, x0: int, Wl: int, j: int, itemsize: int) -> tuple[int, int]:
    """`row_word`: the aligned 4-byte word j of the patch row at level row
    y of a query whose level starts at byte address `base`, as (its
    address, the patch column of its element 0)."""
    a0 = base + (y * Wl + x0) * itemsize
    return (a0 & ~3) + 4 * j, (4 // itemsize) * j - (a0 & 3) // itemsize


def words_a_row(radius: int, itemsize: int) -> int:
    """Words a patch row of S = 2r+2 taps: S/2 + 1 bf16 pairs, S float32."""
    S = 2 * radius + 2
    return S if itemsize == 4 else S // 2 + 1


def row_words(base: int, Hl: int, Wl: int, yy: int, x0: int, radius: int,
              itemsize: int) -> tuple[int, list[int | None]]:
    """`PatchRow::load`: the phase of the patch row at level row yy, and the
    address of each of its words that is read (None: no tap of the word on
    the level, read as 0)."""
    S, E = 2 * radius + 2, 4 // itemsize
    a, t0 = row_word(base, yy, x0, Wl, 0, itemsize)
    phase, out = -t0, []
    for j in range(words_a_row(radius, itemsize)):
        cols = [E * j - phase + h for h in range(E)]
        any_ = any(0 <= t < S and 0 <= x0 + t < Wl for t in cols)
        out.append(a + 4 * j if 0 <= yy < Hl and any_ else None)
    return phase, out


def unpack_row(halves: list[list[float]], phase: int, x0: int, Wl: int,
               radius: int) -> list[float]:
    """`PatchRow::unpack`: the row's S taps from its words' elements
    (`halves[j]`, E values each; zeros for a word not read), shifted by
    the phase, zero off the level."""
    S = 2 * radius + 2
    flat = [v for w in halves for v in w]
    vals = flat[phase:phase + S]
    return [v if 0 <= x0 + t < Wl else 0.0 for t, v in enumerate(vals)]


def owned_word(base: int, Hl: int, Wl: int, y0: int, x0: int, s: int, j: int, radius: int,
               itemsize: int) -> tuple[bool, int, list[int]]:
    """`owned_word`: whether the thread of patch row s updates word j of that
    row of an accumulator, its address, and each element's patch slot (-1:
    not a patch element on the level). Row s's thread takes the words that
    hold a patch element of row s, except a word whose element 0 is the
    previous row's last element and a patch element of that row (row s-1's
    thread takes it and adds both)."""
    S, yy, E = 2 * radius + 2, y0 + s, 4 // itemsize
    addr, t0 = row_word(base, yy, x0, Wl, j, itemsize)
    slots = [s * S + t0 + h if (0 <= yy < Hl and 0 <= t0 + h < S and 0 <= x0 + t0 + h < Wl)
             else -1 for h in range(E)]
    own = any(v >= 0 for v in slots)
    if E == 2 and own:
        last_in, first_in = x0 <= Wl - 1 < x0 + S, x0 <= 0 < x0 + S
        if slots[0] < 0 and x0 + t0 == -1 and s >= 1 and yy >= 1 and last_in:
            return False, addr, slots
        if slots[1] < 0 and x0 + t0 + 1 == Wl and s + 1 < S and yy + 1 < Hl and first_in:
            slots[1] = (s + 1) * S - x0
    return own, addr, slots


def word_mode(base: int, Hl: int, Wl: int, itemsize: int) -> bool:
    """`word_mode`: an accumulator is updated in 4-byte words when every
    query's rows start on a word."""
    return (Hl * Wl) % (4 // itemsize) == 0 and base % 4 == 0


def store_units(n: int, itemsize: int, tid: int, nthreads: int,
                aligned: bool = True) -> list[tuple[int, int]]:
    """The [begin, end) element runs of a block's span of `n` elements
    that thread `tid` of `nthreads` moves (R1 stores its staged output so,
    R2 loads its slice of dout so): 16-byte units u = tid, tid + nthreads,
    ... where the span starts 16-byte aligned, then single elements."""
    v = 16 // itemsize
    units = n // v if aligned else 0
    return ([(u * v, u * v + v) for u in range(tid, units, nthreads)]
            + [(e, e + 1) for e in range(units * v + tid, n, nthreads)])


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
                 radius: int, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """coords and levels as R1 took them, dout (B, h, w, L (2r+1)^2)
        float32 or bfloat16, `grads` one accumulator a level (its level's
        shape and dtype, contiguous), which the launch adds the levels'
        gradients into -> d coords (B, h, w, 2) float32."""
        check_lookup_args("R2", coords, levels, radius)
        want = (*coords.shape[:3], len(levels) * (2 * radius + 1) ** 2)
        if (dout.device != coords.device or dout.dtype not in (torch.float32, torch.bfloat16)
                or tuple(dout.shape) != want):
            raise ValueError(f"R2 takes a float32 or bfloat16 dout {want} on {coords.device}; "
                             f"got {dout.dtype} {tuple(dout.shape)} on {dout.device}")
        if len(grads) != len(levels) or any(
                g.device != t.device or g.dtype != t.dtype or g.shape != t.shape
                or not g.is_contiguous() for g, t in zip(grads, levels)):
            raise ValueError("R2 takes one accumulator a level, contiguous, of its level's "
                             "shape, dtype and device")
        op = self._op
        if op is None:
            op = self._op = OPS.build().raft_lookup_backward.default
        dcoords = op(coords, list(levels), dout.contiguous(), list(grads), radius)
        self.launches += 1
        return dcoords


LOOKUP = RaftLookupKernel()
LOOKUP_BACKWARD = RaftLookupBackward()
OPS = TorchOps("raft_lookup_ops.cpp", (LOOKUP,), "dsfm_raft")
BUILDS = (LOOKUP, OPS)   # what chip_smoke.py's setup builds, with B1 and B2


def raft_lookup_cuda(coords: torch.Tensor, levels: Sequence[torch.Tensor], radius: int,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch R1 on the current stream (see `RaftLookupKernel.__call__`)."""
    return LOOKUP(coords, levels, radius, out_dtype)


def raft_lookup_backward_cuda(coords: torch.Tensor, levels: Sequence[torch.Tensor],
                              dout: torch.Tensor, radius: int,
                              grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Launch R2 on the current stream (see `RaftLookupBackward.__call__`)."""
    return LOOKUP_BACKWARD(coords, levels, dout, radius, grads)
