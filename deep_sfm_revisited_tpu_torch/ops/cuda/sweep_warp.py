"""Kernel B1: the bilinear gather, DICL's displacement volume and the fused plane-sweep cost volume, in CUDA for Hopper.

All replace `deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py::
bilinear_sample_pallas` (`pallas_call` at `:145`); the JAX package's PSNet
reaches it through `plane_sweep_warp_pallas` (`:169`). One source,
`csrc/sweep_warp.cu`, built at first use by `ops/cuda/build.py`, exports six
entry points; `csrc/sweep_warp_ops.cpp` registers them as the PyTorch operators
`torch.ops.dsfm.*` (`OPS`), through which each wrapper launches its kernel
and adds one to its own launch count:

- `bilinear_sample_cuda` (`KERNEL.launches`): the generic gather. Plain
  version `ops/camera.py::bilinear_sample_plain`;
  `ops/camera.py::bilinear_sample` sends CUDA tensors here. No main path
  reaches it: PWC-DC's flow warps are fused into B2's warped correlation
  (`ops/cuda/local_corr.py`), DICL's into its displacement volume.
- `displacement_volume_cuda` (`DISPLACEMENT.launches`): one DICL level's
  (B, S2, 2C, h, w) displacement stack of x and y warped by the level's
  flow, in one pass. Plain version `models/dicl.py::
  displacement_volume_plain` (`shifted_pairs` of `warp_flow`);
  `models/dicl.py::displacement_volume` sends CUDA tensors here. Its work
  mapping (store width, tiles, bands, the persistent grid)
  is `displacement_plan`.
- `displacement_volume_backward_cuda` (`DISPLACEMENT_BACKWARD.launches`):
  that stack's gradient with respect to x and y (DICL detaches the flow).
  Plain version `models/dicl.py::displacement_volume_backward_plain`;
  `models/dicl.py::DisplacementVolumeFn.backward` sends CUDA tensors here.
  Its work mapping (tiles, channel groups, 16-byte runs) is
  `displacement_backward_plan`.
- `plane_sweep_volume_cuda` (`VOLUME.launches`): PSNet's whole
  (B, D, H, W, 2C) [ref | warped] volume, coordinates computed inline. Plain
  version `ops/camera.py::plane_sweep_volume_plain`;
  `ops/camera.py::plane_sweep_volume` sends CUDA tensors here.
- `plane_sweep_volume_backward_cuda` (`VOLUME_BACKWARD.launches`): the
  volume's gradient with respect to both feature maps. Plain version
  `ops/camera.py::plane_sweep_volume_backward_plain`;
  `ops/camera.py::PlaneSweepVolumeFn.backward` sends CUDA tensors here. Its
  work mapping (tiles, plane groups, the shared accumulator) is
  `backward_plan`, and its box rule `ops/camera.py::sweep_tap_box_plain`.
- `plane_sweep_volume_pose_grad_cuda` (`VOLUME_POSE_GRAD.launches`): the
  volume's gradient with respect to M = K R K^-1 and K t, the pose (two
  passes, a fixed-order float64 reduction: the same bits every launch).
  Plain version `ops/camera.py::plane_sweep_volume_pose_grad_plain`;
  `ops/camera.py::PlaneSweepVolumeFn.backward` sends CUDA tensors here when
  the pose requires grad. It replaces XLA's gradient of the JAX package's
  cost volume with respect to the pose (`models/psnet.py:253-260`).

The source's header says what bounds each kernel and how its design answers
that.

The launch path is one dispatcher call, because the gather's kernel takes
~2 us on the card and its host path sets its pace: the checks, the
allocation, the device guard, the current stream (the capture stream inside
`torch.cuda.graph`) and the launch run in C++ (`csrc/sweep_warp_ops.cpp`,
which says why). Each wrapper holds its operator after the first build, so
a launch takes no lock. Nothing synchronises, so the gather can be captured
in a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel, TorchOps

# the sweep backward's default work mapping (csrc/sweep_warp.cu:
# default_tile, kBwdPlanes, kBwdSmemBytes, kBwdThreads)
BWD_THREADS, BWD_PLANES, BWD_SMEM_BYTES = 256, 16, 64 * 1024


def backward_plan(C: int, itemsize: int) -> tuple[int, int, int, int]:
    """(tile_h, tile_w, planes, smem_bytes) the sweep backward kernel takes
    by default for C channels of `itemsize` bytes: about 256 threads, tpp =
    C itemsize / 16 a pixel, on a tile as square as a power-of-two width
    allows; 16 planes a group; a 64 KB shared accumulator, which holds
    smem_bytes / (4 C) box pixels."""
    tpp = C * itemsize // 16
    ppt = max(BWD_THREADS // tpp, 1)
    w = 1
    while w * w < ppt:
        w *= 2
    w = min(w, ppt)
    return ppt // w, w, BWD_PLANES, BWD_SMEM_BYTES


# the displacement backward's work mapping (csrc/sweep_warp.cu: kDispBwdThreads,
# kDispBwdRows, kDispBwdChunks, kDispBwdWords)
DISP_BWD_THREADS, DISP_BWD_ROWS, DISP_BWD_CHUNKS, DISP_BWD_WORDS = 256, 4, 8, 4


@dataclass(frozen=True)
class DisplacementBackwardPlan:
    """The displacement backward kernel's work mapping for one level (see
    `displacement_backward_kernel` in `csrc/sweep_warp.cu`).

    A block owns one batch item, `DISP_BWD_THREADS // 32` channels (a warp
    each) and a tile of `DISP_BWD_ROWS` rows x `tile_w` pixels; block =
    ((b cgroups + cg) tiles_y + ty) tiles_x + tx. Lane l of a warp sums the
    `run` pixels of run l % `DISP_BWD_CHUNKS` of tile row l // `DISP_BWD_CHUNKS`
    (16 bytes of the dtype: one vector load a half and displacement where
    `vector`).
    """

    run: int
    tile_w: int
    tiles_x: int
    tiles_y: int
    cgroups: int
    blocks: int
    vector: bool


def displacement_backward_plan(B: int, C: int, h: int, w: int, itemsize: int,
                               aligned: bool = True) -> DisplacementBackwardPlan:
    """The mapping the kernel launches with for (B, C, h, w) of `itemsize`
    bytes; `aligned`: dout, dx and dy start on 16 bytes (the launcher's
    test), which with w a multiple of the run makes every run one vector."""
    run = 16 // itemsize
    tile_w = DISP_BWD_CHUNKS * run
    tiles_x, tiles_y = -(-w // tile_w), -(-h // DISP_BWD_ROWS)
    cgroups = -(-C // (DISP_BWD_THREADS // 32))
    return DisplacementBackwardPlan(run=run, tile_w=tile_w, tiles_x=tiles_x, tiles_y=tiles_y,
                                    cgroups=cgroups, blocks=B * cgroups * tiles_y * tiles_x,
                                    vector=w % run == 0 and aligned)


# the displacement volume's work mapping (csrc/sweep_warp.cu: kDispThreads,
# kDispBlocksPerSm, kDispMaxTileW, kDispPad, kDispSmemMax)
DISP_THREADS, DISP_BLOCKS_PER_SM, DISP_MAX_TILE_W, DISP_PAD = 256, 2, 1024, 8
DISP_SMEM_MAX = 200 * 1024
DISP_SMEM_BUDGET = 96 * 1024      # a block's shared memory: two blocks an SM
DISP_ITEM_BYTES = 384 * 1024      # output an item at most, where bands could be taller
DISP_SMS = 132                    # the H100 SXM's SMs, where no device is asked


@dataclass(frozen=True)
class DisplacementPlan:
    """The displacement-volume kernel's work mapping for one level (see
    `displacement_volume_kernel` in `csrc/sweep_warp.cu`).

    An item is (b, dv, a band of `band_h` rows, a tile of `tile_w` pixels):
    item = ((b S + dv + md) bands + ty) tiles_x + tx. Its block stages the
    ys rows py + dv of its band (every channel, the tile and DISP_PAD
    pixels each side) and stores both halves of every channel for every du
    of its band and tile. In the store phase a unit is a channel and a
    `vec`-pixel chunk of the band, u = c band_h tile_w / vec + (row, chunk),
    and thread t runs units t, t + DISP_THREADS, ...
    """

    vec: int          # pixels a thread stores at once: 16, 8, 4 bytes or one element
    tile_w: int
    tiles_x: int
    band_h: int
    bands: int
    items: int
    smem: int         # shared-memory bytes a block
    fused: bool       # with a flow: the store kernel samples y itself, no sample launch
    grid: int         # persistent blocks: min(items, sms DISP_BLOCKS_PER_SM)


def displacement_smem(C: int, band_h: int, tile_w: int, itemsize: int) -> int:
    """Shared-memory bytes of the store kernel (csrc/sweep_warp.cu: DispSmem)."""
    pitch = -(-(tile_w + 2 * DISP_PAD) // 32) * 32
    return 2 * C * band_h * pitch * itemsize + 2 * band_h * (pitch // 32 + 1) * 4


def displacement_plan(B: int, C: int, h: int, w: int, md: int, itemsize: int,
                      aligned: int = 16, sms: int = DISP_SMS, band_h: int | None = None,
                      tiles_x: int | None = None, grid: int | None = None,
                      fused: bool | None = None) -> DisplacementPlan:
    """The mapping the kernel launches with for x, y (B, C, h, w) of
    `itemsize` bytes and max displacement md on `sms` SMs; `aligned`: the
    largest power of two up to 16 that x's and y's addresses are multiples
    of.

    Stores are the widest of 16, 8, 4 bytes that w itemsize and the
    alignment allow, else one element. A tile is the whole width where its
    rows fit the shared-memory budget (a plane's band is then one contiguous
    run of the stack), else the fewest equal tiles that do. Bands are the
    tallest of 4, 2, 1 rows whose item stays within DISP_ITEM_BYTES of
    output while the level keeps half a round of resident blocks in items;
    the rule that `b1_compare.py --volume-plans` found closest to the best
    mapping at slice 1's and the training step's levels on an H100. Where an
    item's samples are one task a thread (8 channels of a pixel), the store
    kernel samples y itself (`fused`: no second launch). `band_h`,
    `tiles_x`, `grid` and `fused` override the choice (for measurement)."""
    S = 2 * md + 1
    vb = next((b for b in (16, 8, 4) if (w * itemsize) % b == 0 and aligned % b == 0),
              itemsize)
    vec = vb // itemsize

    def tile(n):
        tw = -(-(-(-w // n)) // vec) * vec
        return -(-w // tw), tw

    def items_of(bh, n):
        return B * S * -(-h // bh) * tile(n)[0]

    slots = sms * DISP_BLOCKS_PER_SM
    n = tiles_x or 1
    while tiles_x is None and n < w and (
            tile(n)[1] > DISP_MAX_TILE_W
            or displacement_smem(C, 1, tile(n)[1], itemsize) > DISP_SMEM_BUDGET):
        n += 1
    tx, tw = tile(n)
    bh = band_h or next(
        (b for b in (4, 2) if b <= h
         and displacement_smem(C, b, tw, itemsize) <= DISP_SMEM_BUDGET
         and S * 2 * C * b * tw * itemsize <= DISP_ITEM_BYTES
         and items_of(b, n) >= slots // 2), 1)
    smem = displacement_smem(C, bh, tw, itemsize)
    if not (1 <= bh and tw <= DISP_MAX_TILE_W and smem <= DISP_SMEM_MAX):
        raise ValueError(f"displacement plan: bands of {bh} rows, tiles of {tw} pixels for "
                         f"C = {C}, w = {w}")
    items = items_of(bh, n)
    if fused is None:
        fused = -(-C // 8) * bh * (tw + 2 * DISP_PAD) <= DISP_THREADS
    return DisplacementPlan(vec=vec, tile_w=tw, tiles_x=tx, band_h=bh, bands=-(-h // bh),
                            items=items, smem=smem, fused=fused, grid=grid or min(items, slots))


def _cuda_only(what: str, *tensors: torch.Tensor) -> None:
    """Refuse CPU tensors before anything is built (the operators check the
    rest)."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"the {what} takes CUDA tensors only")


class SweepWarpKernel(CudaKernel):
    """The kernels' library (plain C launchers, linked by `OPS`); owns the
    generic gather's launch count."""

    source = "sweep_warp.cu"

    def __init__(self):
        super().__init__()
        self._op = None

    def _bind(self, lib) -> None:
        """Nothing to bind: the operators of `OPS` call the launchers."""

    def __call__(self, img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, C) f32/bf16, coords (B, ..., 2) f32 -> (B, ..., C)."""
        op = self._op
        if op is None:
            _cuda_only("gather", img, coords)
            # the overload's C++ callable, which OpOverload.__call__ calls:
            # the gather is host-bound, so one Python frame fewer counts
            op = self._op = OPS.build().bilinear_sample.default._op
        out = op(img, coords)
        self.launches += 1
        return out


DISPLACEMENT_MAX_MD, DISPLACEMENT_MAX_C = 4, 64   # csrc/sweep_warp.cu: kDispMaxMd, kDispMaxC


def refuse_flow_gradient(flow: torch.Tensor | None) -> None:
    """Raise where the flow a displacement volume warps with would need a
    gradient: DICL detaches it (JAX `models/dicl.py:348`), and neither the
    kernel's backward nor the plain one computes dflow."""
    if flow is not None and flow.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("the displacement volume has no flow gradient; detach the "
                                  "flow it warps with, as DICL does")


def check_displacement_args(x: torch.Tensor, y: torch.Tensor, flow: torch.Tensor | None,
                            md: int) -> None:
    """Raise on what the displacement-volume kernels do not take: a flow that
    needs a gradient (`refuse_flow_gradient`), x and y not of one float32 or
    bfloat16 dtype and one (B, C, h, w) shape with 1 <= C <= 64 and
    h w < 2^24, a flow not float32 (B, 2, h, w), md outside 0..4, an input
    not contiguous or not on CUDA. Checked here, not only in the operator,
    so that the CPU tests see every refusal."""
    tensors = (x, y) if flow is None else (x, y, flow)
    refuse_flow_gradient(flow)
    if x.dtype not in (torch.float32, torch.bfloat16) or y.dtype != x.dtype:
        raise TypeError(f"displacement volume x {x.dtype}, y {y.dtype}; takes one of "
                        "float32 or bfloat16")
    if x.dim() != 4 or y.shape != x.shape or min(x.shape) < 1:
        raise ValueError(f"displacement volume shapes x {tuple(x.shape)}, y {tuple(y.shape)}")
    B, C, h, w = x.shape
    if C > DISPLACEMENT_MAX_C or h * w >= 2**24:
        raise ValueError(f"displacement volume x {tuple(x.shape)}; takes C <= "
                         f"{DISPLACEMENT_MAX_C} and h w < 2^24")
    if not (isinstance(md, int) and 0 <= md <= DISPLACEMENT_MAX_MD):
        raise ValueError(f"displacement volume md = {md}; takes 0..{DISPLACEMENT_MAX_MD}")
    if flow is not None:
        if flow.dtype != torch.float32:
            raise TypeError(f"displacement volume flow {flow.dtype}; takes float32")
        if tuple(flow.shape) != (B, 2, h, w):
            raise ValueError(f"displacement volume flow {tuple(flow.shape)}; takes "
                             f"{(B, 2, h, w)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the displacement volume takes contiguous inputs")
    _cuda_only("displacement volume", *tensors)


def address_alignment(t: torch.Tensor) -> int:
    """The largest power of two up to 16 that t's address is a multiple of."""
    p = t.data_ptr()
    return next(a for a in (16, 8, 4, 2, 1) if p % a == 0)


_SMS: dict[int, int] = {}


def device_sms(device: torch.device) -> int:
    """SMs of a CUDA device, asked once."""
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


class DisplacementVolume:
    """Launches DICL's displacement-volume kernel through `OPS` under
    `displacement_plan`'s mapping; owns its launch count."""

    def __init__(self):
        self.launches = 0
        self._op = None
        self._plans: dict[tuple, DisplacementPlan] = {}

    def plan(self, x: torch.Tensor, y: torch.Tensor, md: int) -> DisplacementPlan:
        """The mapping for x, y (B, C, h, w) on their device, made once a
        shape and alignment."""
        aligned = min(address_alignment(x), address_alignment(y))
        key = (tuple(x.shape), md, x.element_size(), aligned, x.device)
        p = self._plans.get(key)
        if p is None:
            B, C, h, w = x.shape
            p = self._plans[key] = displacement_plan(B, C, h, w, md, x.element_size(),
                                                     aligned=aligned, sms=device_sms(x.device))
        return p

    def __call__(self, x: torch.Tensor, y: torch.Tensor, flow: torch.Tensor | None,
                 md: int, plan: DisplacementPlan | None = None) -> torch.Tensor:
        """x, y (B, C, h, w) f32/bf16, flow (B, 2, h, w) f32 or None ->
        (B, (2md+1)^2, 2C, h, w) in x's dtype (`check_displacement_args`
        says what it refuses); `plan` overrides the mapping (measurement)."""
        check_displacement_args(x, y, flow, md)
        op = self._op
        if op is None:
            op = self._op = OPS.build().displacement_volume.default
        p = plan or self.plan(x, y, md)
        out = op(x, y, flow, md, p.vec * x.element_size(), p.tile_w, p.band_h, int(p.fused),
                 p.grid)
        self.launches += 1
        return out


class DisplacementVolumeBackward:
    """Launches the displacement volume's backward kernel through `OPS`; owns
    its launch count."""

    def __init__(self):
        self.launches = 0
        self._op = None

    def __call__(self, dout: torch.Tensor, y: torch.Tensor, flow: torch.Tensor | None,
                 md: int) -> tuple[torch.Tensor, torch.Tensor]:
        """dout (B, (2md+1)^2, 2C, h, w), the volume's gradient, and y
        (B, C, h, w) of one dtype, f32/bf16; flow (B, 2, h, w) f32 or None,
        as the forward took them -> (dx, dy), each (B, C, h, w) in dout's
        dtype (with a flow, dy is summed in a float32 buffer, then cast in
        bfloat16)."""
        check_displacement_args(y, y, flow, md)
        S = 2 * md + 1
        B, C, h, w = y.shape
        if dout.dtype != y.dtype or tuple(dout.shape) != (B, S * S, 2 * C, h, w) \
                or not dout.is_contiguous():
            raise ValueError(f"displacement volume backward dout {tuple(dout.shape)} "
                             f"{dout.dtype}; takes a contiguous {(B, S * S, 2 * C, h, w)} "
                             f"{y.dtype}")
        _cuda_only("displacement volume backward", dout)
        op = self._op
        if op is None:
            op = self._op = OPS.build().displacement_volume_backward.default
        dx, dy = op(dout, y, flow, md)
        self.launches += 1
        return dx, dy


class PlaneSweepVolume:
    """Launches the sweep kernel through `OPS`; owns its launch count."""

    def __init__(self):
        self.launches = 0
        self._op = None

    def __call__(self, ref: torch.Tensor, tgt: torch.Tensor, depths: torch.Tensor,
                 M: torch.Tensor, Kt: torch.Tensor) -> torch.Tensor:
        """ref, tgt (B, H, W, C) f32/bf16; depths (D,), M (B, 3, 3), Kt (B, 3)
        f32 -> (B, D, H, W, 2C) [ref | warped] in the features' dtype."""
        op = self._op
        if op is None:
            _cuda_only("sweep kernel", ref, tgt, depths, M, Kt)
            op = self._op = OPS.build().plane_sweep_volume.default
        out = op(ref, tgt, depths, M, Kt)
        self.launches += 1
        return out


class PlaneSweepVolumeBackward:
    """Launches the sweep's backward kernel through `OPS`; owns its launch
    count."""

    def __init__(self):
        self.launches = 0
        self._op = None

    def __call__(self, dvol: torch.Tensor, depths: torch.Tensor, M: torch.Tensor,
                 Kt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """dvol (B, D, H, W, 2C) f32/bf16, the volume's gradient; depths (D,),
        M (B, 3, 3), Kt (B, 3) f32 -> (dref, dtgt), each (B, H, W, C) in dvol's
        dtype. dtgt is summed in a float32 buffer, then cast."""
        op = self._op
        if op is None:
            _cuda_only("sweep backward", dvol, depths, M, Kt)
            op = self._op = OPS.build().plane_sweep_volume_backward.default
        dref, dtgt = op(dvol, depths, M, Kt)
        self.launches += 1
        return dref, dtgt


class PlaneSweepVolumePoseGrad:
    """Launches the sweep's pose-gradient kernel through `OPS`; owns its
    launch count."""

    def __init__(self):
        self.launches = 0
        self._op = None

    def __call__(self, dvol: torch.Tensor, tgt: torch.Tensor, depths: torch.Tensor,
                 M: torch.Tensor, Kt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """dvol (B, D, H, W, 2C) and tgt (B, H, W, C) of one dtype, f32/bf16;
        depths (D,), M (B, 3, 3), Kt (B, 3) f32 -> (dM (B, 3, 3), dKt (B, 3))
        float32."""
        op = self._op
        if op is None:
            _cuda_only("sweep pose gradient", dvol, tgt, depths, M, Kt)
            op = self._op = OPS.build().plane_sweep_volume_pose_grad.default
        dM, dKt = op(dvol, tgt, depths, M, Kt)
        self.launches += 1
        return dM, dKt


def plane_sweep_volume_backward_probe(dvol: torch.Tensor, depths: torch.Tensor,
                                      M: torch.Tensor, Kt: torch.Tensor,
                                      plan: tuple[int, int, int, int] | None = None):
    """The sweep backward kernel under the work mapping `plan` (tile_h,
    tile_w, planes, smem_bytes; None: `backward_plan`'s), counting what it
    did: -> (dref, dtgt float32, {shared_groups, direct_groups,
    left_box_samples, global_reductions}). For measurement; it does not add
    to `VOLUME_BACKWARD.launches`."""
    _cuda_only("sweep backward", dvol, depths, M, Kt)
    plan = plan or backward_plan(dvol.shape[-1] // 2, dvol.element_size())
    dref, acc, stats = OPS.build().plane_sweep_volume_backward_probe(dvol, depths, M, Kt, *plan)
    keys = ("shared_groups", "direct_groups", "left_box_samples", "global_reductions")
    return dref, acc, dict(zip(keys, stats.tolist()))


KERNEL = SweepWarpKernel()
OPS = TorchOps("sweep_warp_ops.cpp", KERNEL, "dsfm")
BUILDS = (KERNEL, OPS)      # what chip_smoke.py's setup builds, in parallel with B2
VOLUME = PlaneSweepVolume()
VOLUME_BACKWARD = PlaneSweepVolumeBackward()
VOLUME_POSE_GRAD = PlaneSweepVolumePoseGrad()
DISPLACEMENT = DisplacementVolume()
DISPLACEMENT_BACKWARD = DisplacementVolumeBackward()


def bilinear_sample_cuda(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Launch the generic gather on the current stream (see `SweepWarpKernel.__call__`)."""
    return KERNEL(img, coords)


def displacement_volume_cuda(x: torch.Tensor, y: torch.Tensor, flow: torch.Tensor | None,
                             md: int, plan: DisplacementPlan | None = None) -> torch.Tensor:
    """Launch DICL's displacement-volume kernel on the current stream (see
    `DisplacementVolume.__call__`)."""
    return DISPLACEMENT(x, y, flow, md, plan)


def displacement_volume_backward_cuda(dout: torch.Tensor, y: torch.Tensor,
                                      flow: torch.Tensor | None, md: int):
    """Launch the displacement volume's backward kernel on the current stream
    (see `DisplacementVolumeBackward.__call__`)."""
    return DISPLACEMENT_BACKWARD(dout, y, flow, md)


def plane_sweep_volume_cuda(ref: torch.Tensor, tgt: torch.Tensor, depths: torch.Tensor,
                            M: torch.Tensor, Kt: torch.Tensor) -> torch.Tensor:
    """Launch the sweep kernel on the current stream (see `PlaneSweepVolume.__call__`)."""
    return VOLUME(ref, tgt, depths, M, Kt)


def plane_sweep_volume_backward_cuda(dvol: torch.Tensor, depths: torch.Tensor,
                                     M: torch.Tensor, Kt: torch.Tensor):
    """Launch the sweep's backward kernel on the current stream (see
    `PlaneSweepVolumeBackward.__call__`)."""
    return VOLUME_BACKWARD(dvol, depths, M, Kt)


def plane_sweep_volume_pose_grad_cuda(dvol: torch.Tensor, tgt: torch.Tensor,
                                      depths: torch.Tensor, M: torch.Tensor, Kt: torch.Tensor):
    """Launch the sweep's pose-gradient kernel on the current stream (see
    `PlaneSweepVolumePoseGrad.__call__`)."""
    return VOLUME_POSE_GRAD(dvol, tgt, depths, M, Kt)
