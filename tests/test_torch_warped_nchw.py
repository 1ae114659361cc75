"""PWC-DC's warped correlation in its own layout and dtype, against the JAX package.

`ops/correlation.py::warped_correlation_nchw` is what PWC-DC's levels 5..2
call: f1, f2 (B, C, H, W) of the network's dtype and the up-sampled flow
(B, 2, H, W) -> the (B, (2md+1)^2, H, W) correlation in f1's dtype. On CUDA
tensors it is one launch of `csrc/warped_corr.cu` (run on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`); on the CPU its plain version
`warped_correlation_nchw_plain`. Here the plain version is held against the
JAX level computation, `local_correlation(f1.astype(f32), warp_flow(f2,
up_flow.astype(f32) * s).astype(f32)).astype(d)` (JAX `models/pwcnet.py:
125-131`), on inputs made with numpy from a seed: float32 and bfloat16
features, float32 and bfloat16 flows, C = 3, 40 and 32, md 4 and 2, flows
that push samples off the frame. The kernel's work mapping
(`ops/cuda/local_corr.py::warped_plan`) is replayed with the kernel's index
arithmetic, and the wrapper's refusals are checked before anything is built.

Tolerances, as `tests/test_torch_warped_correlation.py` states them: float32
to 1e-6 absolute; in bfloat16 a warped value may land on the neighbouring
bf16 value where the two frameworks' float32 blends differ by an ulp at a
rounding boundary, so per output element 2^-8 times the correlation of |f1|
with |warped f2|, plus 1e-6; and a bfloat16 output one bf16 ulp of the
output more, since the two sums may round to neighbouring bf16 values.
"""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.models import dicl as jdicl
from deep_sfm_revisited_tpu.ops.correlation import local_correlation as j_corr
from deep_sfm_revisited_tpu_torch.ops import correlation as tcorr
from deep_sfm_revisited_tpu_torch.ops.camera import bilinear_sample_plain
from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr as lc

torch.set_num_threads(1)

# (B, C, H, W): C not a multiple of 4 and odd sizes, a batch of two with C
# split unevenly across a cluster, and level 2's C
SHAPES = [(1, 3, 9, 13), (2, 40, 7, 11), (1, 32, 12, 16)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed, flow_kind, flow_dtype):
    """f1, f2 (B, C, H, W) and a flow (B, 2, H, W) of a few pixels, float32
    numpy arrays (the flow's values those of `flow_dtype`); "off" sends a
    band of samples frames away, a row just past the last one and a column
    just before the first."""
    B, C, H, W = shape
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, C, H, W).astype(np.float32)
    f2 = rng.randn(B, C, H, W).astype(np.float32)
    flow = rng.uniform(-2.5, 2.5, (B, 2, H, W)).astype(np.float32)
    if flow_kind == "off":
        flow[:, 0, :, -2:] = 3.0 * W
        flow[:, 1, -1, :] = 1.5
        flow[:, 0, :, 0] = -0.401
    flow = torch.from_numpy(flow).to(flow_dtype).float().numpy()
    return f1, f2, flow


def _jax_level(f1, f2, flow, scale, md, jd):
    """JAX's level computation on NHWC arrays, as (B, (2md+1)^2, H, W); the
    flow's values are already those of its dtype."""
    nhwc = lambda a: jnp.asarray(np.moveaxis(a, 1, -1))  # noqa: E731
    warped = jdicl.warp_flow(nhwc(f2).astype(jd), nhwc(flow) * jnp.float32(scale))
    corr = j_corr(nhwc(f1).astype(jd).astype(jnp.float32), warped.astype(jnp.float32),
                  md).astype(jd)
    return np.moveaxis(np.asarray(corr.astype(jnp.float32)), -1, 1)


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x))
    return np.ldexp(np.ones_like(x), e - 8)


def _tolerance(f1, f2, flow, scale, md, dtype, ref):
    """Elementwise (module docstring)."""
    if dtype == torch.float32:
        return 1e-6
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 1, -1)))  # noqa: E731
    B, _, H, W = f2.shape
    grid = torch.stack(torch.meshgrid(torch.arange(H, dtype=torch.float32),
                                      torch.arange(W, dtype=torch.float32), indexing="ij")[::-1])
    coords = (grid[None] + torch.from_numpy(flow) * scale).permute(0, 2, 3, 1)
    warped = bilinear_sample_plain(t(f2).to(dtype), coords).float()
    bound = tcorr.local_correlation_plain(t(f1).to(dtype).float().abs(), warped.abs(), md)
    return 2.0 ** -8 * bound.permute(0, 3, 1, 2).numpy() + 1e-6 + _bf16_ulp(ref)


@pytest.mark.parametrize("md", [4, 2])
@pytest.mark.parametrize("flow_kind", ["flow", "off"])
@pytest.mark.parametrize("flow_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["b1c3_9x13", "b2c40_7x11", "b1c32_12x16"])
def test_nchw_plain_matches_jax_level(shape, dtype, flow_dtype, flow_kind, md):
    td, jd = DTYPES[dtype]
    tf = DTYPES[flow_dtype][0]
    f1, f2, flow = _inputs(shape, seed=shape[1] + md + len(flow_kind), flow_kind=flow_kind,
                           flow_dtype=tf)
    scale = 1.25
    ref = _jax_level(f1, f2, flow, scale, md, jd)
    got = tcorr.warped_correlation_nchw(torch.from_numpy(f1).to(td), torch.from_numpy(f2).to(td),
                                        torch.from_numpy(flow).to(tf), scale, md)
    B, _, H, W = shape
    assert got.dtype == td and got.shape == (B, (2 * md + 1) ** 2, H, W)
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = np.abs(got.float().numpy() - ref)
    assert (err <= _tolerance(f1, f2, flow, scale, md, td, ref)).all(), err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nchw_plain_is_the_nhwc_function_between_permutes(dtype):
    """The NCHW entry computes what PWC-DC computed before through the NHWC
    float32 contract: `warped_correlation_plain` of the permuted float32
    f1 and f2 in its own dtype, cast back, bit for bit."""
    td = DTYPES[dtype][0]
    f1, f2, flow = (torch.from_numpy(a) for a in _inputs((2, 5, 7, 9), 3, "off", torch.float32))
    f1, f2, fl = f1.to(td), f2.to(td), flow.to(torch.bfloat16)
    want = tcorr.warped_correlation(f1.permute(0, 2, 3, 1).float(), f2.permute(0, 2, 3, 1),
                                    fl.float(), 2.5, 3)
    got = tcorr.warped_correlation_nchw(f1, f2, fl, 2.5, 3)
    assert torch.equal(got, want.permute(0, 3, 1, 2).to(td))


# both main paths' level shapes (B, C, H, W) -- a slice-2 pair at 384x1280
# and a training step at b = 4, 256x768, levels 5..2 -- then odd shapes
PLAN_SHAPES = [(1, 128, 12, 40), (1, 96, 24, 80), (1, 64, 48, 160), (1, 32, 96, 320),
               (4, 128, 8, 24), (4, 96, 16, 48), (4, 64, 32, 96), (4, 32, 64, 192),
               (2, 40, 13, 27), (1, 3, 5, 7), (1, 32, 3, 300)]


def _kernel_constant(name):
    src = (Path(lc.__file__).resolve().parents[2] / "csrc" / "warped_corr.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def replay(p, B, C, H, W, md):
    """How many times the kernel's index arithmetic sums each (rank, b, y,
    x, dy row) and writes each output element (b, channel, y, x) under the
    mapping `p`: threads (tx, ty, dy row) sum their px pixels; each tile row
    is written from shared memory by a strided loop over its columns x 81
    channels, rank k taking the runs i with (i // threads) % cluster == k."""
    s, th = 2 * md + 1, lc.TILE_H
    threads = lc.THREAD_COLS * th * s
    tx, ty, dyr = np.meshgrid(np.arange(lc.THREAD_COLS), np.arange(th), np.arange(s),
                              indexing="ij")
    summed = np.zeros((p.cluster, B, H, W, s), np.int64)
    written = np.zeros((B, s * s, H, W), np.int64)
    for gx in range(p.grid[0]):
        rank, x0 = gx % p.cluster, (gx // p.cluster) * p.tile_w
        nx = min(p.tile_w, W - x0)
        i = np.arange(nx * s * s)
        mine = i[(i // threads) % p.cluster == rank]
        for gy in range(p.grid[1]):
            y0 = gy * th
            for b in range(B):
                ys, xs = y0 + ty, x0 + tx * p.px
                for q in range(p.px):
                    m = (xs + q < W) & (ys < H)
                    np.add.at(summed, (rank, b, ys[m], xs[m] + q, dyr[m]), 1)
                for r in range(min(th, H - y0)):
                    np.add.at(written, (b, mine % (s * s), y0 + r, x0 + mine // (s * s)), 1)
    return summed, written


@pytest.mark.parametrize("md", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_warped_plan_covers_the_output(shape, md):
    """`warped_plan`'s mapping, replayed with the kernel's index arithmetic:
    every (pixel, dy row) summed exactly once by each cluster rank, every
    output element written exactly once, the ranks' channel shares a
    partition of C on groups of 4, and sizes the source instantiates."""
    B, C, H, W = shape
    p = lc.warped_plan(B, C, H, W, md)
    assert (lc.TILE_H, lc.THREAD_COLS, lc.MAX_CLUSTER) == (
        _kernel_constant("kTileH"), _kernel_constant("kCols"), _kernel_constant("kMaxCluster"))
    assert p.px in lc.WARPED_PIXELS and p.block == (lc.THREAD_COLS, lc.TILE_H, 2 * md + 1)
    assert 1 <= p.cluster <= lc.MAX_CLUSTER and p.cluster <= -(-C // 4)
    assert p.grid[0] % p.cluster == 0 and p.grid[2] == B
    assert p.shares[0][0] == 0 and p.shares[-1][1] == C
    assert all(e0 == b1 for (_, e0), (b1, _) in zip(p.shares, p.shares[1:]))
    assert all(b < e and b % 4 == 0 for b, e in p.shares)
    summed, written = replay(p, B, C, H, W, md)
    assert (summed == 1).all() and (written == 1).all()


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("px", [1, 2])
@pytest.mark.parametrize("md", [2, 4])
def test_every_mapping_covers_the_output(md, px, cluster):
    """Mappings a grid times, beyond the plan's choice: the same coverage at
    an odd shape with C split unevenly."""
    B, C, H, W = 2, 40, 13, 27
    p = lc.warped_mapping(B, C, H, W, md, px, cluster)
    summed, written = replay(p, B, C, H, W, md)
    assert (summed == 1).all() and (written == 1).all()


class _OnCard(types.SimpleNamespace):
    """A CPU tensor's attributes as the wrapper's checks read them, with the
    device a card's and channels-last contiguity as given: the refusals
    past the device check run without one."""

    def __init__(self, t, device="cuda:0", channels_last=True, requires_grad=False):
        super().__init__(is_cuda=True, device=torch.device(device), dtype=t.dtype,
                         shape=t.shape, requires_grad=requires_grad, _t=t, _cl=channels_last)

    def dim(self):
        return self._t.dim()

    def is_contiguous(self, memory_format=torch.contiguous_format):
        return self._cl if memory_format == torch.channels_last else self._t.is_contiguous()


def test_wrapper_refusals():
    """CPU tensors, wrong dtypes, shapes and layouts (features not
    channels-last), md outside 1..4 and a gradient are refused before
    anything is built, and so are bfloat16 features on the NHWC entry's
    CUDA route; other devices raise in the dispatcher."""
    f = torch.zeros(1, 4, 6, 8)
    flow = torch.zeros(1, 2, 6, 8)
    with pytest.raises(ValueError, match="CUDA"):
        lc.warped_correlation_cuda(f, f, flow, 1.0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        lc.warped_correlation_cuda(_OnCard(f), _OnCard(f), flow, 1.0, 4)
    card = lambda t, **kw: _OnCard(t, **kw)  # noqa: E731
    refused = [
        ((card(f), card(f, device="cuda:1"), card(flow), 1.0, 4), ValueError),
        ((card(f.double()), card(f.double()), card(flow), 1.0, 4), TypeError),
        ((card(f), card(f.bfloat16()), card(flow), 1.0, 4), TypeError),
        ((card(f), card(f), card(flow.half()), 1.0, 4), TypeError),
        ((card(f), card(f[:, :2]), card(flow), 1.0, 4), ValueError),
        ((card(f[0]), card(f[0]), card(flow), 1.0, 4), ValueError),
        ((card(f), card(f), card(flow[:, :1]), 1.0, 4), ValueError),
        ((card(f), card(f, channels_last=False), card(flow), 1.0, 4), ValueError),
        ((card(f, channels_last=False), card(f), card(flow), 1.0, 4), ValueError),
        ((card(f), card(f), card(flow), 1.0, 5), ValueError),
        ((card(f), card(f), card(flow), 1.0, 0), ValueError),
    ]
    for args, error in refused:
        with pytest.raises(error):
            lc.warped_correlation_cuda(*args)
    nhwc = f.permute(0, 2, 3, 1)
    for a, b in ((nhwc, nhwc.bfloat16()), (nhwc.bfloat16(), nhwc.bfloat16())):
        with pytest.raises(TypeError, match="warped_correlation_nchw"):
            tcorr.warped_correlation(card(a), card(b), card(flow), 1.0, 4)
    with torch.enable_grad(), pytest.raises(NotImplementedError, match="autograd function"):
        lc.warped_correlation_cuda(card(f, requires_grad=True), card(f), card(flow), 1.0, 4)
    m = torch.zeros(1, 4, 6, 8, device="meta")
    with pytest.raises(NotImplementedError):
        tcorr.warped_correlation_nchw(m, m, torch.zeros(1, 2, 6, 8, device="meta"), 1.0, 4)
