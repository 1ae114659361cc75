"""DICL's displacement volume in the port against the JAX package.

`models/dicl.py::displacement_volume` builds one level's (B, S2, 2C, H, W)
stack of [x | y warped by the level's flow] pairs; on CUDA tensors it is one
launch of kernel B1's fused entry point (`dsfm_displacement_volume`), on the
CPU its plain version, `shifted_pairs(x, warp_flow(y, flow), md)` with the
gather's plain version. Here the CPU path is held against the JAX package's
`shifted_pairs(x, warp_flow(y, flow), md)` (and `shifted_pairs(x, y, md)`
without a flow) on inputs made with numpy from a seed: md 2 and 3, odd H and
W, float32 and bfloat16, flows that push samples off the frame, and all-zero
patches of y that open warp holes. The wrapper's refusals run here too (the
kernel itself runs on the card: `tests/test_torch_cuda.py`).

Tolerances: without a flow the stack is a copy and masks, so it is exact.
With a flow, float32 to 1e-6 (values of order 1; the two frameworks' blends
round alike, XLA may fuse differently) and bfloat16 to one bf16 rounding
(2^-8 of the value, after the float32 blend), with the zero pattern (frame,
warp holes) equal.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.models import dicl as jdicl
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models import dicl as tdicl
from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp

torch.set_num_threads(1)

# (B, C, H, W): odd H and W, a batch of two
SHAPES = [(2, 8, 9, 11), (1, 5, 13, 7)]


def _inputs(shape, seed, flow_kind):
    """x, y (B, H, W, C) float32 with an all-zero patch of y (a warp hole),
    and a flow (B, H, W, 2) or None: "flow" up to 3 px, "off" pushes a band
    of samples several frames off and others just past the border."""
    B, C, H, W = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    y = rng.randn(B, H, W, C).astype(np.float32)
    y[:, 2:6, 1:5] = 0.0
    if flow_kind == "none":
        return x, y, None
    flow = rng.uniform(-3, 3, (B, H, W, 2)).astype(np.float32)
    flow[:, 3:5, 2:4] = rng.uniform(-0.4, 0.4, (B, 2, 2, 2))   # inside the zero patch
    if flow_kind == "off":
        flow[:, :, -2:, 0] = 3.0 * W
        flow[:, -1, :, 1] = 1.5                                 # just below the last row
        flow[:, 0, :, 0] = -np.arange(W, dtype=np.float32) - 1e-3
    return x, y, flow


def _jax_stack(x, y, flow, md, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jy = jnp.asarray(x, dtype=jd), jnp.asarray(y, dtype=jd)
    if flow is not None:
        jy = jdicl.warp_flow(jy, jnp.asarray(flow))
    out = jdicl.shifted_pairs(jx, jy, md)                     # (B, S2, H, W, 2C)
    return np.asarray(out.astype(jnp.float32))


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous().to(dtype)


def _port_stack(x, y, flow, md, dtype):
    with torch.no_grad():
        out = tdicl.displacement_volume(_nchw(x, dtype), _nchw(y, dtype),
                                        None if flow is None else _nchw(flow), md)
    return out.permute(0, 1, 3, 4, 2).float().numpy()        # JAX's layout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("flow_kind", ["none", "flow", "off"])
@pytest.mark.parametrize("md", [2, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=["b2c8_9x11", "b1c5_13x7"])
def test_displacement_volume_matches_jax(shape, md, flow_kind, dtype):
    x, y, flow = _inputs(shape, 10 * md + len(flow_kind), flow_kind)
    got = _port_stack(x, y, flow, md, dtype)
    ref = _jax_stack(x, y, flow, md, dtype)
    B, C, H, W = shape
    assert got.shape == ref.shape == (B, (2 * md + 1) ** 2, H, W, 2 * C)
    np.testing.assert_array_equal(got == 0, ref == 0)         # frame and holes alike
    if flow is None:
        np.testing.assert_array_equal(got, ref)
    elif dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -8, atol=0)


@pytest.mark.parametrize("flow_kind", ["none", "flow"])
def test_warp_holes_zero_whole_pairs(flow_kind):
    """A pair whose shifted y is all-zero in the frame is zero in both
    halves, and such pairs exist (the zero patch of y, with flows that keep
    its samples inside it)."""
    x, y, flow = _inputs((1, 4, 12, 10), 3, flow_kind)
    got = _port_stack(x, y, flow, 3, torch.float32)
    C = 4
    y_zero = (got[..., C:] == 0).all(-1)
    x_nonzero = (x != 0).all(-1)[:, None]                    # x has no zero channel
    outside = _outside(12, 10, 3)[None]
    holes = y_zero & ~outside
    assert holes.any()
    assert not (holes & x_nonzero & (got[..., :C] != 0).any(-1)).any()
    assert ((got[..., :C] != 0).any(-1) == (~y_zero & ~outside)).all()


def _outside(h, w, md):
    """(S2, H, W) True where p + (du, dv) leaves the frame (dv outer)."""
    d = np.arange(-md, md + 1)
    dv, du = np.repeat(d, 2 * md + 1), np.tile(d, 2 * md + 1)
    ys = np.arange(h)[None, :, None] + dv[:, None, None]
    xs = np.arange(w)[None, None, :] + du[:, None, None]
    return (ys < 0) | (ys >= h) | (xs < 0) | (xs >= w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_cpu_dispatch_is_the_plain_composition(dtype):
    """On CPU tensors the dispatcher is `shifted_pairs` of `warp_flow`, bit
    for bit, and never reaches the kernel's wrapper."""
    x, y, flow = (_nchw(a, dtype) if a is not None and a.shape[-1] != 2 else a
                  for a in _inputs((2, 6, 9, 11), 5, "off"))
    flow = _nchw(flow)
    before = sweep_warp.DISPLACEMENT.launches
    got = tdicl.displacement_volume(x, y, flow, 3)
    want = tdicl.shifted_pairs(x, tdicl.warp_flow(y, flow), 3)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(tdicl.displacement_volume(x, y, None, 2), tdicl.shifted_pairs(x, y, 2))
    assert sweep_warp.DISPLACEMENT.launches == before


def test_dispatcher_refuses_other_devices():
    x = torch.empty(1, 4, 6, 6, device="meta")
    with pytest.raises(NotImplementedError):
        tdicl.displacement_volume(x, x, None, 3)


def _refused():
    """Arguments the wrapper refuses, each with the error it raises."""
    x = torch.zeros(1, 8, 6, 10)
    f = torch.zeros(1, 2, 6, 10)
    return [
        ((x, x, f, 3), ValueError),                                # CPU tensors
        ((x, x.bfloat16(), f, 3), TypeError),                      # two dtypes
        ((x.double(), x.double(), f, 3), TypeError),               # float64
        ((x, x, f.bfloat16(), 3), TypeError),                      # a bf16 flow
        ((x, x[:, :, :5], f, 3), ValueError),                      # two shapes
        ((x[0], x[0], None, 3), ValueError),                       # no batch axis
        ((x, x, f[:, :1], 3), ValueError),                         # a flow of one channel
        ((x, x, f, 5), ValueError),                                # md beyond 4
        ((x, x, f, -1), ValueError),
        ((torch.zeros(1, 65, 6, 10),) * 2 + (f, 3), ValueError),   # C beyond 64
        ((x.transpose(2, 3), x.transpose(2, 3), None, 3), ValueError),   # not contiguous
        ((x.transpose(2, 3).contiguous().transpose(2, 3), x, f, 3), ValueError),
    ]


@pytest.mark.parametrize("case", range(len(_refused())))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, error = _refused()[case]
    before = sweep_warp.DISPLACEMENT.launches
    with torch.no_grad(), pytest.raises(error):
        sweep_warp.displacement_volume_cuda(*args)
    assert sweep_warp.DISPLACEMENT.launches == before


def test_wrapper_refuses_inputs_that_need_a_gradient():
    """The volume has a backward for x and y but none for the flow: a flow
    that requires grad under grad mode raises; x that requires grad passes
    the check (and then meets the CUDA-only refusal on this CPU tensor), as
    does the flow under torch.no_grad()."""
    x = torch.zeros(1, 8, 6, 10, requires_grad=True)
    y = torch.zeros(1, 8, 6, 10)
    flow = torch.zeros(1, 2, 6, 10, requires_grad=True)
    with pytest.raises(NotImplementedError, match="flow gradient"):
        sweep_warp.displacement_volume_cuda(y, y, flow, 3)
    with pytest.raises(ValueError, match="CUDA"):
        sweep_warp.displacement_volume_cuda(x, y, None, 3)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        sweep_warp.displacement_volume_cuda(y, y, flow, 3)


def test_dicl_builds_one_volume_a_level(monkeypatch):
    """DICLFlow's eval forward calls the dispatcher once a level, coarse to
    fine: no flow at level 6, then each level's upsampled flow (float32,
    the level's shape), with the configured md."""
    cfg = TConfig.kitti().flow
    net = tdicl.DICLFlow(cfg).eval()
    calls = []
    real = tdicl.displacement_volume

    def recording(x, y, flow, md):
        calls.append((tuple(x.shape), None if flow is None else (tuple(flow.shape), flow.dtype),
                      md))
        return real(x, y, flow, md)

    monkeypatch.setattr(tdicl, "displacement_volume", recording)
    pair = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (1, 128, 128, 6))
                            .astype(np.float32))
    with torch.no_grad():
        net(pair)
    sizes = [128 // s for s in (64, 32, 16, 8, 4)]
    assert [c[0] for c in calls] == [(1, 32, s, s) for s in sizes]
    assert calls[0][1] is None
    assert [c[1] for c in calls[1:]] == [((1, 2, s, s), torch.float32) for s in sizes[1:]]
    assert [c[2] for c in calls] == list(cfg.dicl_search_range)[::-1]


def _kernel_constant(name):
    """A `constexpr int` of csrc/sweep_warp.cu: a number or a product of two."""
    src = (Path(sweep_warp.__file__).resolve().parents[2] / "csrc" / "sweep_warp.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\d+)(?: \* (\d+))?;", src)
    return int(m.group(1)) * int(m.group(2) or 1)


# slice 1's five levels (b = 1, 384x1280), the training step's five (b = 4,
# 256x768), all C = 32, md 3; and the card tests' odd shapes (tests/
# test_torch_cuda.py::DISP_CASES), at md 0..4
PLAN_SHAPES = [((1, 32, 6, 20), 3), ((1, 32, 12, 40), 3), ((1, 32, 24, 80), 3),
               ((1, 32, 48, 160), 3), ((1, 32, 96, 320), 3), ((4, 32, 4, 12), 3),
               ((4, 32, 8, 24), 3), ((4, 32, 16, 48), 3), ((4, 32, 32, 96), 3),
               ((4, 32, 64, 192), 3)] + [
    (shape, md) for shape in ((2, 16, 13, 27), (1, 5, 9, 51), (2, 32, 10, 36), (1, 8, 5, 6))
    for md in range(5)]


def _replay(B, C, h, w, md, itemsize, p):
    """Times each output element is written, with the index arithmetic of
    `displacement_volume_sample` (with a flow: the centre displacement's y
    half) and of `displacement_volume_kernel` (every item, every thread of
    its store phase), counted over (B, S2, 2, h, w) -- x half and y half --
    as difference arrays along w; the thread mapping of the channels and a
    band's chunks is replayed on its own (it is the same for every item).
    With `p.fused` the store kernel samples y itself and writes the centre
    too. Also checks each staged chunk and each thread's shared-memory
    window and keep-flag words against the kernel's buffers (DispSmem)."""
    S, threads, pad = 2 * md + 1, sweep_warp.DISP_THREADS, sweep_warp.DISP_PAD
    V, s0 = p.vec, md * S + md
    assert p.tiles_x == -(-w // p.tile_w) and p.bands == -(-h // p.band_h)
    assert p.items == B * S * p.bands * p.tiles_x
    pitch = -(-(p.tile_w + 2 * pad) // 32) * 32
    kwords = pitch // 32 + 1
    assert p.smem == sweep_warp.displacement_smem(C, p.band_h, p.tile_w, itemsize)
    assert p.smem == 2 * C * p.band_h * pitch * itemsize + 2 * p.band_h * kwords * 4
    assert p.smem <= _kernel_constant("kDispSmemMax")
    assert (p.tile_w + 2 * pad) % V == 0 and pad % V == 0 and pad >= md
    item = np.arange(p.items)
    tx, rem = item % p.tiles_x, item // p.tiles_x
    ty, rem = rem % p.bands, rem // p.bands
    dvi, b = rem % S, rem // S
    x0, y0 = tx * p.tile_w, ty * p.band_h
    tw = np.minimum(p.tile_w, w - x0)
    starts = np.zeros((B, S * S, 2, h, w + 1), np.int64)
    for with_flow in (False, True):
        starts[:] = 0
        with_flow = with_flow and not p.fused   # fused: the store kernel writes it
        if with_flow:   # the sample kernel: every (b, q) of the centre's y half
            starts[:, s0, 1, :, 0] += 1
            starts[:, s0, 1, :, w] -= 1
        for i in range(p.band_h):
            py = y0 + i
            m = py < h
            for du in range(-md, md + 1):
                s = dvi[m] * S + du + md
                for half in (0, 1):
                    keep = np.ones(s.shape, bool) if half == 0 or not with_flow else s != s0
                    idx = (b[m][keep], s[keep], half, py[m][keep])
                    np.add.at(starts, idx + (x0[m][keep],), 1)
                    np.add.at(starts, idx + ((x0 + tw)[m][keep],), -1)
        written = np.cumsum(starts, axis=-1)[..., :w]
        assert (written == 1).all(), with_flow
    # the store phase: thread t runs units t, t + threads, ..., unit u =
    # channel u // positions, (row, chunk) u % positions; every unit once,
    # and each unit's ys window and flag words inside the buffers
    tc = p.tile_w // V
    positions = p.band_h * tc
    seen = np.zeros((C, positions), np.int64)
    for t in range(threads):
        for u in range(t, positions * C, threads):
            seen[u // positions, u % positions] += 1
    assert (seen == 1).all()
    for pos in range(positions):
        pj = pos % tc
        # the ys window of du = -md .. md: from element pad + pj V - md, the
        # words it lies in and the next, inside the row
        last_word = ((pad + pj * V + md) * itemsize >> 2) + max(V * itemsize // 4, 1)
        assert pad + pj * V - md >= 0 and last_word < pitch * itemsize // 4
        bit = pad - md + pj * V                # K: one funnel shift of two words
        assert (bit >> 5) + 1 < kwords and 2 * md + V <= 32


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("shape,md", PLAN_SHAPES)
def test_volume_plan_covers_every_element(shape, md, itemsize):
    """The volume kernel's work mapping (`sweep_warp.displacement_plan`),
    replayed with the kernels' index arithmetic: every output element, both
    halves of every channel, is written exactly once, with and without a
    flow (with one, the centre displacement's y half by the sample kernel
    and never again); staged chunks, windows and flag words stay in their
    buffers; stores are the widest of 16, 8, 4 bytes that w and the address
    allow; a tile is the whole width where its rows fit the budget; a band
    taller than a row keeps its item within DISP_ITEM_BYTES and the level
    at half a round of resident blocks; the sampling is fused where an
    item's samples are one task a thread. The plan's constants are the
    kernel's."""
    assert (sweep_warp.DISP_THREADS, sweep_warp.DISP_BLOCKS_PER_SM, sweep_warp.DISP_MAX_TILE_W,
            sweep_warp.DISP_PAD, sweep_warp.DISP_SMEM_MAX) == tuple(_kernel_constant(n) for n in (
                "kDispThreads", "kDispBlocksPerSm", "kDispMaxTileW", "kDispPad", "kDispSmemMax"))
    B, C, h, w = shape
    S = 2 * md + 1
    slots = sweep_warp.DISP_SMS * sweep_warp.DISP_BLOCKS_PER_SM
    for aligned in (16, 8, 2):
        p = sweep_warp.displacement_plan(B, C, h, w, md, itemsize, aligned=aligned)
        vb = p.vec * itemsize
        assert vb == max([b for b in (16, 8, 4) if (w * itemsize) % b == 0 and aligned % b == 0],
                         default=itemsize)
        for fused in (False, True):
            _replay(B, C, h, w, md, itemsize, dataclasses.replace(p, fused=fused))
        assert p.grid == min(p.items, slots)
        assert p.fused == (-(-C // 8) * p.band_h * (p.tile_w + 2 * sweep_warp.DISP_PAD)
                           <= sweep_warp.DISP_THREADS)
        assert p.tiles_x == 1 or sweep_warp.displacement_smem(
            C, 1, w, itemsize) > sweep_warp.DISP_SMEM_BUDGET
        assert p.band_h == 1 or (p.items >= slots // 2 and p.smem <= sweep_warp.DISP_SMEM_BUDGET
                                 and S * 2 * C * p.band_h * p.tile_w * itemsize
                                 <= sweep_warp.DISP_ITEM_BYTES)
