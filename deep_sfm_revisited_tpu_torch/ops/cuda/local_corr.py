"""Kernel B2 and PWC-DC's warped correlation, as CUDA kernels for Hopper,
and their backward kernels.

Both forwards replace `deep_sfm_revisited_tpu/ops/pallas/local_corr.py::
local_correlation_pallas` (`pallas_call` at `:80`); the warped one also
replaces B1's gather (`ops/pallas/sweep_warp.py::bilinear_sample_pallas`)
on PWC-DC's flow warps. Three sources, `csrc/local_corr.cu` (B2),
`csrc/warped_corr.cu` (the warped correlation) and
`csrc/warped_corr_backward.cu` (both backwards), built at first use by
`ops/cuda/build.py`; `csrc/local_corr_ops.cpp` registers their entry points
as the PyTorch operators `torch.ops.dsfm_corr.*` (`OPS`), through which each
wrapper launches and adds one to its own count:

- `local_correlation_cuda` (`KERNEL.launches`): the windowed correlation of
  NHWC float32 maps. Plain version `ops/correlation.py::
  local_correlation_plain`; `ops/correlation.py::local_correlation` sends
  CUDA tensors here (PWC-DC's level 6).
- `warped_correlation_cuda` (`WARPED.launches`): the correlation of f1 with
  f2 sampled at q + scale flow(q) by B1's rule, in PWC-DC's layout and
  dtype ((B, C, H, W) float32 or bfloat16 features, channels-last in
  memory, the output likewise), with no warped map in device memory.
  Plain version `ops/correlation.py::warped_correlation_nchw_plain`;
  `ops/correlation.py::warped_correlation_nchw` sends CUDA tensors here
  (PWC-DC's levels 5..2), and `warped_correlation` (JAX's NHWC contract,
  float32 features) too, between permutes.
- `local_correlation_backward_cuda` (`KERNEL_BACKWARD.launches`): B2's
  gradients (d f0, d f1), the flow-free case of the backward template.
  Plain version `ops/correlation.py::local_correlation_backward_plain`.
- `warped_correlation_backward_cuda` (`WARPED_BACKWARD.launches`): the
  warped correlation's gradients (d f1, d f2, d flow) in its forward's
  layouts and dtypes. Plain version `ops/correlation.py::
  warped_correlation_nchw_backward_plain`.

The forwards refuse inputs that require a gradient while grad mode is on:
those go through `ops/correlation.py`'s autograd functions, whose backward
is the backward kernel.

The sources' headers say what bounds the kernels and how their designs
answer that. `plan`, `warped_plan` and `backward_plan` pick the work
mappings from the shape; they need no card, so the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel, TorchOps

MAX_MD = 4           # the source instantiates md = 1..4 (PWC-DC uses 4)
TILE_H = 4           # output rows per block (`kTileH`, both sources)
THREAD_COLS = 8      # thread columns per block (`kCols`)
PIXELS_PER_THREAD = (4, 2, 1)   # the source instantiates these PX
MAX_CLUSTER = 8      # `kMaxCluster`: the portable cluster size
TARGET_WARPS = 1024  # ~8 warps on each of the H100's 132 SMs
WARPED_PIXELS = (2, 1)   # the warped correlation's pixels a thread (`warped_corr.cu`)
MIN_BLOCKS = 120     # the warped correlation's grid: about a block on each of 132 SMs
# the backward kernels (`warped_corr_backward.cu`)
BWD_RUNS = (1, 2, 4)     # the template's RUN: pixels a thread sums along a row
BWD_SLOT = 8             # `kSlot`: channels a thread owns
BWD_MAX_THREADS = 512    # `kMaxThreads`
BWD_SMEM_MAX = 232448    # `kSmemMax`: 227 KB of dynamic shared memory a block
BWD_TILES_H = (1, 2, 4, 8)            # the mappings `backward_plan` and the grid choose from
BWD_TILES_W = (4, 8, 12, 16, 32)
BWD_SLOTS = (1, 2, 4, 8, 16, 32)


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


def check_correlation_args(what: str, f0: torch.Tensor, f1: torch.Tensor, md: int) -> None:
    """Raise on what B2's kernel does not take: f0 or f1 not float32, not
    one (B, H, W, C) shape with every size >= 1, not contiguous, md outside
    1..4, a tensor not on CUDA or the two on two devices. Checked here, not
    only in the operators, so the CPU tests see every refusal."""
    if not (f0.is_cuda and f1.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors only")
    if f0.device != f1.device:
        raise ValueError(f"f0 on {f0.device}, f1 on {f1.device}")
    if f0.dtype != torch.float32 or f1.dtype != torch.float32:
        raise TypeError(f"{what} dtypes {f0.dtype}, {f1.dtype}; takes float32")
    if f0.dim() != 4 or f0.shape != f1.shape:
        raise ValueError(f"{what} shapes f0 {tuple(f0.shape)}, f1 {tuple(f1.shape)}")
    if not (f0.is_contiguous() and f1.is_contiguous()):
        raise ValueError(f"{what} takes contiguous NHWC f0 and f1")
    if not 1 <= md <= MAX_MD:
        raise ValueError(f"{what} max displacement {md}; takes 1..{MAX_MD}")
    if min(f0.shape) < 1:
        raise ValueError(f"{what} feature shape {tuple(f0.shape)} out of range")


@dataclass(frozen=True)
class WarpedPlan:
    """The warped correlation's work mapping for one shape (see the header
    of `csrc/warped_corr.cu`).

    A block covers `TILE_H` rows x `tile_w` columns of one image with one
    warp per displacement row (blockDim (8, 4, 2md+1)); each thread sums
    `px` adjacent pixels. `cluster` blocks along grid.x share one tile and
    split its channels, rank k taking `shares[k]`.
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
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def warps(self) -> int:
        return self.blocks * self.block[2]


def warped_mapping(B: int, C: int, H: int, W: int, md: int, px: int,
                   cluster: int) -> WarpedPlan:
    """The launch geometry of one (px, cluster) mapping."""
    tiles_x, tiles_y = -(-W // (THREAD_COLS * px)), -(-H // TILE_H)
    return WarpedPlan(px=px, cluster=cluster, grid=(tiles_x * cluster, tiles_y, B),
                      block=(THREAD_COLS, TILE_H, 2 * md + 1), shares=channel_shares(C, cluster))


@functools.lru_cache(maxsize=256)
def warped_plan(B: int, C: int, H: int, W: int, md: int) -> WarpedPlan:
    """The mapping the warped correlation launches with for f1, f2 (B, C, H,
    W) and max displacement md, chosen from a measured grid at both main
    paths' levels 5..2 (`b2_compare.py --warped-plans`, PERF.md section 6).

    Two pixels a thread where the tiles overhang W by at most W/8, else
    one; then the fewest ranks of a channel split (1, 2, 4, 8, every rank
    keeping a group of 4 channels) that bring the grid to `MIN_BLOCKS`
    blocks. The measured best did not depend on the dtype by more than a
    few percent.
    """
    px = 2 if -(-W // (THREAD_COLS * 2)) * THREAD_COLS * 2 - W <= W // 8 else 1
    groups = (C + 3) // 4
    cluster = 1
    while (cluster < MAX_CLUSTER and 2 * cluster <= groups
           and warped_mapping(B, C, H, W, md, px, cluster).blocks < MIN_BLOCKS):
        cluster *= 2
    return warped_mapping(B, C, H, W, md, px, cluster)


def check_warped_args(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                      md: int) -> None:
    """Raise on what the warped correlation does not take: a tensor not on
    CUDA or not on one device; f1 not float32 or bfloat16, f2 of another
    dtype, the flow not float32 or bfloat16; f1, f2 not one (B, C, H, W)
    shape with every size >= 1, the flow not (B, 2, H, W); f1 or f2 not
    channels-last contiguous; md outside 1..4. Checked here, not only in
    the operator, so the CPU tests see every refusal."""
    what = "the warped correlation"
    if not (f1.is_cuda and f2.is_cuda and flow.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors only")
    if not f1.device == f2.device == flow.device:
        raise ValueError(f"{what}: f1 on {f1.device}, f2 on {f2.device}, flow on {flow.device}")
    floats = (torch.float32, torch.bfloat16)
    if f1.dtype not in floats or f2.dtype != f1.dtype or flow.dtype not in floats:
        raise TypeError(f"{what} dtypes f1 {f1.dtype}, f2 {f2.dtype}, flow {flow.dtype}; takes "
                        "f1 and f2 of one dtype and a flow, each float32 or bfloat16")
    if f1.dim() != 4 or f2.shape != f1.shape or min(f1.shape) < 1:
        raise ValueError(f"{what} shapes f1 {tuple(f1.shape)}, f2 {tuple(f2.shape)}")
    B, _, H, W = f1.shape
    if tuple(flow.shape) != (B, 2, H, W):
        raise ValueError(f"{what} flow {tuple(flow.shape)}; takes {(B, 2, H, W)}")
    cl = torch.channels_last
    if not (f1.is_contiguous(memory_format=cl) and f2.is_contiguous(memory_format=cl)):
        raise ValueError(f"{what} takes channels-last contiguous f1 and f2")
    if not 1 <= md <= MAX_MD:
        raise ValueError(f"{what} max displacement {md}; takes 1..{MAX_MD}")


def refuse_gradient(what: str, *tensors: torch.Tensor) -> None:
    """Raise where a forward kernel is called, with grad mode on, on a
    tensor that needs a gradient: autograd would not see the launch. Inside
    an autograd function's forward grad mode is off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{what} on tensors that require a gradient goes through "
                                  "ops/correlation.py (its autograd function)")


@dataclass(frozen=True)
class BackwardPlan:
    """The backward kernels' work mapping for one shape (see the header of
    `csrc/warped_corr_backward.cu`).

    A block owns a `tile_h` x `tile_w` tile of one image and `slots` slots
    of `BWD_SLOT` channels (a channel group); a thread owns `run` adjacent
    pixels of a tile row and one slot. The `groups` groups of a
    tile are adjacent blocks along grid.x and, with a flow, one cluster of
    `cluster` = `groups` ranks, which add their partial d flow in rank
    order. `smem` is a block's dynamic shared memory (`backward_smem`).
    """

    tile_h: int
    tile_w: int
    run: int
    slots: int
    groups: int
    cluster: int
    grid: tuple[int, int, int]
    threads: int
    smem: int

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def key(self) -> str:
        return f"{self.tile_h}x{self.tile_w}_r{self.run}_s{self.slots}"


def backward_smem(md: int, itemsize: int, flow: bool, tile_h: int, tile_w: int,
                  slots: int) -> int:
    """A block's dynamic shared memory, as the kernel's `layout` lays it
    out: the (tile_h + 2md) x (tile_w + 2md) halo in 16-byte units at an
    odd pitch, the staged dout (tile pixels x (2md+1)^2 values, padded to an
    even count in bfloat16, the buffer to 16 bytes), two index tables (4
    bytes a halo and a tile pixel, padded to 16 bytes) and, with a flow, the
    halo's taps (16 bytes a pixel), each thread's partial d flow (8 bytes a
    pixel and slot) and the block's (8 bytes a pixel)."""
    hp = (tile_h + 2 * md) * (tile_w + 2 * md)
    units = slots * BWD_SLOT * itemsize // 16
    s2 = (2 * md + 1) ** 2
    gp = s2 + (1 if itemsize == 2 and s2 % 2 else 0)
    npix = tile_h * tile_w
    total = (hp * (units | 1) * 16 + -(-npix * gp * itemsize // 16) * 16
             + -(-(hp + npix) * 4 // 16) * 16)
    if flow:
        total += hp * 16 + npix * slots * 8 + npix * 8
    return total


def backward_mapping(B: int, C: int, H: int, W: int, md: int, itemsize: int, flow: bool,
                     tile_h: int, tile_w: int, run: int, slots: int) -> BackwardPlan | None:
    """The launch geometry of one (tile, run, slots) mapping, or None where
    the kernel does not take it (threads over `BWD_MAX_THREADS`, shared
    memory over `BWD_SMEM_MAX`, with a flow more than `MAX_CLUSTER` groups;
    a run not in `BWD_RUNS` or a tile width that is no multiple of it;
    slots that are no power of two)."""
    if (run not in BWD_RUNS or tile_w % run or tile_h < 1 or slots < 1
            or slots & (slots - 1)):
        return None
    threads = tile_h * (tile_w // run) * slots
    groups = -(-C // (slots * BWD_SLOT))
    smem = backward_smem(md, itemsize, flow, tile_h, tile_w, slots)
    if threads > BWD_MAX_THREADS or smem > BWD_SMEM_MAX or (flow and groups > MAX_CLUSTER):
        return None
    tiles_x, tiles_y = -(-W // tile_w), -(-H // tile_h)
    return BackwardPlan(tile_h=tile_h, tile_w=tile_w, run=run, slots=slots, groups=groups,
                        cluster=groups if flow else 1, grid=(tiles_x * groups, tiles_y, B),
                        threads=threads, smem=smem)


def backward_mappings(B: int, C: int, H: int, W: int, md: int, itemsize: int,
                      flow: bool) -> list[BackwardPlan]:
    """Every mapping of the grid (`BWD_TILES_H` x `BWD_TILES_W` x
    `BWD_RUNS` x `BWD_SLOTS`) the kernel takes at this shape, without tiles
    or slots larger than the frame or the channels need."""
    out = []
    for th in BWD_TILES_H:
        if th > 1 and th // 2 >= H:
            continue
        for tw in BWD_TILES_W:
            if tw > 4 and tw - 4 >= W:
                continue
            for run in BWD_RUNS:
                for ns in BWD_SLOTS:
                    if ns > 1 and (ns // 2) * BWD_SLOT >= C:
                        continue
                    p = backward_mapping(B, C, H, W, md, itemsize, flow, th, tw, run, ns)
                    if p is not None:
                        out.append(p)
    return out


@functools.lru_cache(maxsize=256)
def backward_plan(B: int, C: int, H: int, W: int, md: int, dtype: torch.dtype,
                  flow: bool) -> BackwardPlan:
    """The mapping the backward kernels launch with for features (B, C, H,
    W) of `dtype` (B2's backward: float32, flow False) and max displacement
    md, fitted to the grid `b2_compare.py --backward-plans` timed at a
    training step's levels (on an H100 80GB HBM3 at 700 W; PERF.md
    section 6): it is the fastest there at every bfloat16 level and B2's
    within 4%, float32 within 19%.

    The frames are small, so parallelism comes first: a run of 1 pixel a
    thread up to 4096 pixels a call (B H W), 2 up to 16384, then 4 in
    bfloat16 (1 in float32, whose slots hold twice the units); a slot
    group as wide as the channels allow up to 8 slots in bfloat16 and 4 in
    float32 (a power of two, widened where a cluster would pass 8 ranks);
    tiles of 4 x 4 pixels up to 1024 pixels a call, else 4 x 12 for a run
    of 1, 8 x 12 for a run of 2 and 8 x 16 for a run of 4, no taller or
    wider than the frame needs.
    """
    itemsize = torch.empty((), dtype=dtype).element_size()
    pixels = B * H * W
    if pixels <= 4096:
        run = 1
    elif pixels <= 16384:
        run = 2
    else:
        run = 4 if itemsize == 2 else 1
    th, tw = {1: (4, 4) if pixels <= 1024 else (4, 12), 2: (8, 12), 4: (8, 16)}[run]
    th = min(th, next(t for t in BWD_TILES_H if t >= H or t == BWD_TILES_H[-1]))
    tw = min(tw, -(-W // 4) * 4)
    ns = min(8 if itemsize == 2 else 4, 1 << ((-(-C // BWD_SLOT)).bit_length() - 1))
    while flow and -(-C // (ns * BWD_SLOT)) > MAX_CLUSTER:
        ns *= 2
    p = backward_mapping(B, C, H, W, md, itemsize, flow, th, tw, run, ns)
    if p is None:
        raise ValueError(f"no backward mapping for C = {C} ({dtype}, flow {flow}): "
                         f"{th}x{tw} run {run} slots {ns}")
    return p


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
        """f0, f1 (B, H, W, C) float32 -> (B, H, W, (2md+1)^2) float32.
        Inputs that need a gradient are refused while grad mode is on:
        `ops/correlation.py::local_correlation` takes them, through its
        autograd function."""
        check_correlation_args("B2", f0, f1, md)
        refuse_gradient("B2", f0, f1)
        p = plan(*f0.shape, md)
        op = self._op
        if op is None:
            op = self._op = OPS.build().local_correlation.default
        out = op(f0, f1, md, p.px, p.cluster)
        self.launches += 1
        return out


class WarpedKernel(CudaKernel):
    """The warped correlation's library (plain C launcher, linked by `OPS`);
    launches through `OPS` and owns its launch count."""

    source = "warped_corr.cu"

    def __init__(self):
        super().__init__()
        self._op = None

    def _bind(self, lib) -> None:
        """The launcher is the operator's (`OPS`); only the resources query
        is called from here."""
        fn = lib.dsfm_warped_correlation_resources
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def resources(self, p: WarpedPlan, dtype: torch.dtype) -> dict:
        """What one mapping's kernel takes on the card: registers a thread,
        dynamic shared memory a block, resident blocks an SM (the occupancy
        calculator's, without the cluster's constraint), threads a block."""
        res = (ctypes.c_int * 4)()
        md = (p.block[2] - 1) // 2
        err = self.build().dsfm_warped_correlation_resources(
            md, p.px, 0 if dtype == torch.float32 else 1, res)
        if err != 0:
            raise RuntimeError(f"the warped correlation's resources query failed: cudaError {err}")
        return dict(registers=res[0], smem_bytes=res[1], blocks_per_sm=res[2], threads=res[3])

    def __call__(self, f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor, scale: float,
                 md: int) -> torch.Tensor:
        """f1, f2 (B, C, H, W) of one dtype, float32 or bfloat16, channels-last
        contiguous, flow (B, 2, H, W) float32 or bfloat16 of any strides, on
        one device -> (B, (2md+1)^2, H, W) in f1's dtype, channels-last.
        Inputs that need a gradient are refused while grad mode is on:
        `ops/correlation.py::warped_correlation_nchw` takes them, through
        its autograd function."""
        check_warped_args(f1, f2, flow, md)
        refuse_gradient("the warped correlation", f1, f2, flow)
        p = warped_plan(*f1.shape, md)
        op = self._op
        if op is None:
            op = self._op = OPS.build().warped_correlation.default
        out = op(f1, f2, flow, float(scale), md, p.px, p.cluster)
        self.launches += 1
        return out


class BackwardKernels(CudaKernel):
    """The backward kernels' library (`csrc/warped_corr_backward.cu`, plain C
    launchers, linked by `OPS`); `LocalCorrBackward` and
    `WarpedCorrBackward` launch them."""

    source = "warped_corr_backward.cu"

    def _bind(self, lib) -> None:
        """The launchers are the operators' (`OPS`); only the resources
        query is called from here."""
        fn = lib.dsfm_corr_backward_resources
        fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def resources(self, p: BackwardPlan, C: int, md: int, dtype: torch.dtype,
                  flow: bool) -> dict:
        """What one mapping's kernel takes on the card: registers a thread,
        dynamic shared memory a block, resident blocks an SM (the occupancy
        calculator's, without the cluster's constraint), threads a block."""
        res = (ctypes.c_int * 4)()
        err = self.build().dsfm_corr_backward_resources(
            md, 0 if dtype == torch.float32 else 1, int(flow), C, p.tile_h, p.tile_w, p.run,
            p.slots, res)
        if err != 0:
            raise RuntimeError(f"the backward kernels' resources query failed: cudaError {err}")
        return dict(registers=res[0], smem_bytes=res[1], blocks_per_sm=res[2], threads=res[3])


class LocalCorrBackward:
    """Launches B2's backward kernel through `OPS`; owns its launch count."""

    def __init__(self):
        self.launches = 0
        self._op = None

    def __call__(self, f0: torch.Tensor, f1: torch.Tensor, dout: torch.Tensor,
                 md: int, plan: BackwardPlan | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """f0, f1 (B, H, W, C) as B2 took them, dout (B, H, W, (2md+1)^2)
        float32 -> (d f0, d f1), float32 (B, H, W, C). The mapping is
        `backward_plan`'s unless `plan` names another (the card tests and
        `b2_compare.py --backward-plans` force each of the grid)."""
        check_correlation_args("B2's backward", f0, f1, md)
        want = (*f0.shape[:3], (2 * md + 1) ** 2)
        if dout.device != f0.device or dout.dtype != torch.float32 or tuple(dout.shape) != want:
            raise ValueError(f"B2's backward takes a float32 dout {want} on {f0.device}; got "
                             f"{dout.dtype} {tuple(dout.shape)} on {dout.device}")
        B, H, W, C = f0.shape
        p = plan or backward_plan(B, C, H, W, md, torch.float32, False)
        op = self._op
        if op is None:
            op = self._op = OPS.build().local_correlation_backward.default
        out = op(f0, f1, dout.contiguous(), md, p.tile_h, p.tile_w, p.run, p.slots)
        self.launches += 1
        return out


class WarpedCorrBackward:
    """Launches the warped correlation's backward kernel through `OPS`; owns
    its launch count."""

    def __init__(self):
        self.launches = 0
        self._op = None

    def __call__(self, f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor, scale: float,
                 dout: torch.Tensor, md: int, plan: BackwardPlan | None = None):
        """f1, f2, flow, scale, md as the forward took them, dout (B,
        (2md+1)^2, H, W) of f1's dtype -> (d f1, d f2) channels-last of f1's
        dtype and d flow of the flow's dtype. A dout whose channels are
        adjacent at one pixel stride (channels-last, or PWC-DC's slice of its
        decoder input's gradient) is read in place; any other is made
        channels-last first. The mapping is `backward_plan`'s unless `plan`
        names another."""
        check_warped_args(f1, f2, flow, md)
        B, C, H, W = f1.shape
        S2 = (2 * md + 1) ** 2
        if (dout.device != f1.device or dout.dtype != f1.dtype
                or tuple(dout.shape) != (B, S2, H, W)):
            raise ValueError(f"the warped correlation's backward takes a {f1.dtype} dout "
                             f"{(B, S2, H, W)} on {f1.device}; got {dout.dtype} "
                             f"{tuple(dout.shape)} on {dout.device}")
        if not (dout.stride(1) == 1 and dout.stride(3) >= S2
                and dout.stride(2) == W * dout.stride(3)):
            dout = dout.contiguous(memory_format=torch.channels_last)
        op = self._op
        if op is None:
            op = self._op = OPS.build().warped_correlation_backward.default
        p = plan or backward_plan(B, C, H, W, md, f1.dtype, True)
        out = op(f1, f2, flow, float(scale), dout, md, p.tile_h, p.tile_w, p.run, p.slots)
        self.launches += 1
        return out


KERNEL = LocalCorrKernel()
WARPED = WarpedKernel()
BACKWARD = BackwardKernels()
KERNEL_BACKWARD = LocalCorrBackward()
WARPED_BACKWARD = WarpedCorrBackward()
OPS = TorchOps("local_corr_ops.cpp", (KERNEL, WARPED, BACKWARD), "dsfm_corr")
BUILDS = (KERNEL, WARPED, BACKWARD, OPS)   # what chip_smoke.py's setup builds, with B1


def local_correlation_cuda(f0: torch.Tensor, f1: torch.Tensor, md: int) -> torch.Tensor:
    """Launch B2 on the current stream (see `LocalCorrKernel.__call__`)."""
    return KERNEL(f0, f1, md)


def warped_correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                            scale: float, md: int) -> torch.Tensor:
    """Launch the warped correlation on the current stream (see
    `WarpedKernel.__call__`)."""
    return WARPED(f1, f2, flow, scale, md)


def local_correlation_backward_cuda(f0: torch.Tensor, f1: torch.Tensor, dout: torch.Tensor,
                                   md: int, plan: BackwardPlan | None = None
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch B2's backward on the current stream (see
    `LocalCorrBackward.__call__`)."""
    return KERNEL_BACKWARD(f0, f1, dout, md, plan)


def warped_correlation_backward_cuda(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                                     scale: float, dout: torch.Tensor, md: int,
                                     plan: BackwardPlan | None = None):
    """Launch the warped correlation's backward on the current stream (see
    `WarpedCorrBackward.__call__`)."""
    return WARPED_BACKWARD(f1, f2, flow, scale, dout, md, plan)
