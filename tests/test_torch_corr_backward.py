"""The backward of PWC-DC's two correlations, against the JAX package.

`ops/correlation.py::local_correlation_backward_plain` (B2's backward) and
`warped_correlation_nchw_backward_plain` (the warped correlation's, in f1,
f2 and the flow) are the plain versions of `csrc/warped_corr_backward.cu`'s
kernels (run on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`);
the autograd functions behind `local_correlation` and
`warped_correlation_nchw` call them on CPU tensors. Here they are held to
`jax.vjp` of JAX's `local_correlation` and of `warp_flow` then
`local_correlation` (with PWC-DC's float32 casts, which are the identity for
float32 features), on inputs made with numpy from a seed: C = 3, 16 and 40,
md = 4, flows that send samples off the frame, exactly onto each edge of
the frame (a zero flow at a border pixel, integer flows that land on the
last row or column) and onto integer positions, and fractional ones.

Tolerances, relative to each gradient's largest element: float64 to 1e-10
(d f1, d f2), float32 to 1e-5 (the sums run in other orders). d flow is
float32 in both packages for float64 features too, since JAX computes its
sample coordinates, and their gradient, in float32: JAX rounds each of the
four taps' channel sums to float32 before it adds them, the port the sum
of their differences once, so d flow is held to 1e-5 in float64 as well.
Autograd of the port's plain forwards agrees in float32 to 1e-5 away from
the samples that land exactly on an edge, where torch's clamp and the
port's clamped +1 tap give another (one-sided) gradient than JAX's clip and
zero pad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.models.dicl import warp_flow as j_warp_flow
from deep_sfm_revisited_tpu.ops.correlation import local_correlation as j_corr
from deep_sfm_revisited_tpu_torch.ops import correlation as tcorr
from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr as lc
from test_torch_warped_nchw import _OnCard

torch.set_num_threads(2)
MD = 4
B, H, W = 2, 7, 9
# C and the level's warp scale (PWC-DC's 0.625 .. 5.0)
CASES = [(3, 0.625), (16, 5.0), (40, 2.5)]
DTYPES = {"float64": np.float64, "float32": np.float32}
TOL = {"float64": 1e-10, "float32": 1e-5}


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def _flow(rng, scale):
    """(B, H, W, 2) float32: per pixel a fractional flow, an integer number
    of 5-pixel steps (a flow the scale multiplies exactly onto integer
    positions), a zero one, or one frames away; the first image's border
    pixels get a zero flow, so their samples lie exactly on the frame's
    edges."""
    kind = rng.randint(0, 4, (B, H, W, 1))
    frac = rng.uniform(-3, 3, (B, H, W, 2))
    ints = rng.randint(-1, 2, (B, H, W, 2)) * (5.0 / scale)   # 8, 2 or 1 times an integer
    far = rng.choice([-2.0 * W, 2.0 * W], (B, H, W, 2))
    flow = np.where(kind == 0, frac, np.where(kind == 1, ints, np.where(kind == 2, 0.0, far)))
    flow = flow.astype(np.float32)
    for border in (np.s_[0, 0], np.s_[0, -1], np.s_[0, :, 0], np.s_[0, :, -1]):
        flow[border] = 0.0
    return flow


def _coords(flow, scale):
    """The float32 sample coordinates both packages compute."""
    gy, gx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    return (gx + flow[..., 0] * np.float32(scale), gy + flow[..., 1] * np.float32(scale))


def _inputs(C, scale, dtype, seed):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(dtype)
    f2 = rng.randn(B, H, W, C).astype(dtype)
    g = rng.randn(B, H, W, (2 * MD + 1) ** 2).astype(dtype)
    return f1, f2, _flow(rng, scale), g


@pytest.fixture(scope="module")
def jax_grads():
    """jax.vjp of both compositions at every case: the correlation's jitted,
    the warped composition's eager. Under jit XLA fuses the coordinates'
    product and sum (grid + flow s) into one rounding, which moves a few
    float32 coordinates by an ulp from what JAX computes eagerly (and the
    port computes); eager, JAX rounds each operation, as the port does."""
    def warped(a, b, f, s):
        # PWC-DC's level: the warp of f2 by the scaled float32 flow, the
        # correlation of the float32 casts, cast back (the casts are the
        # identity for float32 features; float64 keeps float64, the point
        # of that case being the formulas)
        w = j_warp_flow(b, f.astype(jnp.float32) * s)
        return j_corr(a, w, MD)

    @jax.jit
    def vjp_local(a, b, g):
        return jax.vjp(lambda x, y: j_corr(x, y, MD), a, b)[1](g)

    out = {}
    for name, dt in DTYPES.items():
        for C, s in CASES:
            f1, f2, flow, g = _inputs(C, s, dt, seed=C)
            j = [jnp.asarray(t) for t in (f1, f2, flow, g)]
            _, vjp_warped = jax.vjp(lambda x, y, z, s=s: warped(x, y, z, s), *j[:3])
            out[name, C] = dict(local=[np.asarray(t) for t in vjp_local(j[0], j[1], j[3])],
                                warped=[np.asarray(t) for t in vjp_warped(j[3])])
    return out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("C,scale", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_local_backward_matches_jax(jax_grads, dtype, C, scale):
    f1, f2, _, g = _inputs(C, scale, DTYPES[dtype], seed=C)
    d0, d1 = tcorr.local_correlation_backward_plain(torch.from_numpy(f1), torch.from_numpy(f2),
                                                    torch.from_numpy(g), MD)
    assert d0.dtype == d1.dtype == torch.from_numpy(f1).dtype
    for got, want in zip((d0, d1), jax_grads[dtype, C]["local"]):
        assert _rel(got.numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("C,scale", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_warped_backward_matches_jax(jax_grads, dtype, C, scale):
    f1, f2, flow, g = _inputs(C, scale, DTYPES[dtype], seed=C)
    x, y = _coords(flow, scale)
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    # not vacuous: samples on every edge, on integer positions, off the frame
    for edge in (x == 0, x == W - 1, y == 0, y == H - 1):
        assert (edge & inside).any()
    assert ((x == np.round(x)) & (y == np.round(y)) & inside).sum() > 10
    assert (~inside).sum() > 10
    d1, d2, df = tcorr.warped_correlation_nchw_backward_plain(
        _nchw(f1), _nchw(f2), _nchw(flow), scale, _nchw(g), MD)
    assert d1.is_contiguous(memory_format=torch.channels_last)
    assert d2.is_contiguous(memory_format=torch.channels_last)
    assert df.dtype == torch.float32 and d1.dtype == d2.dtype == _nchw(f1).dtype
    j1, j2, jf = jax_grads[dtype, C]["warped"]
    assert np.abs(jf).max() > 1e-2
    assert _rel(d1.permute(0, 2, 3, 1).numpy(), j1) <= TOL[dtype]
    assert _rel(d2.permute(0, 2, 3, 1).numpy(), j2) <= TOL[dtype]
    assert _rel(df.permute(0, 2, 3, 1).numpy(), jf) <= 1e-5
    # where the sample is off the frame, its flow gets no gradient
    assert (df.permute(0, 2, 3, 1).numpy()[~inside] == 0).all()


@pytest.mark.parametrize("C,scale", CASES)
def test_plain_backwards_match_autograd_of_the_plain_forwards(C, scale):
    """float32, fractional flows (no sample exactly on an edge)."""
    rng = np.random.RandomState(100 + C)
    f1, f2 = (torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32)) for _ in range(2))
    f1, f2 = f1.contiguous(memory_format=torch.channels_last), f2.contiguous(
        memory_format=torch.channels_last)
    flow = torch.from_numpy(rng.uniform(-4, 4, (B, 2, H, W)).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, (2 * MD + 1) ** 2, H, W).astype(np.float32))
    x, y = _coords(flow.permute(0, 2, 3, 1).numpy(), scale)
    assert not ((x == 0) | (x == W - 1) | (y == 0) | (y == H - 1)).any()
    leaves = [t.clone().requires_grad_() for t in (f1, f2, flow)]
    out = tcorr.warped_correlation_nchw_plain(*leaves, scale, MD)
    want = torch.autograd.grad(out, leaves, g)
    got = tcorr.warped_correlation_nchw_backward_plain(f1, f2, flow, scale, g, MD)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5
    a, b = (t.permute(0, 2, 3, 1).contiguous().requires_grad_() for t in (f1, f2))
    gl = g.permute(0, 2, 3, 1).contiguous()
    want = torch.autograd.grad(tcorr.local_correlation_plain(a, b, MD), (a, b), gl)
    got = tcorr.local_correlation_backward_plain(a.detach(), b.detach(), gl, MD)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5


def test_autograd_functions_take_the_plain_backward_on_the_cpu():
    """`local_correlation` and `warped_correlation_nchw` differentiate
    through their autograd functions: on CPU tensors the gradients are the
    plain backward's, bit for bit, in bfloat16 too (d w kept in float32);
    an input that needs no gradient gets none; the forward is the plain
    version's."""
    rng = np.random.RandomState(7)
    C, scale = 16, 2.5
    f1, f2, flow, g = _inputs(C, scale, np.float32, seed=7)
    for dt in (torch.float32, torch.bfloat16):
        a = _nchw(f1).to(dt).contiguous(memory_format=torch.channels_last)
        b = _nchw(f2).to(dt).contiguous(memory_format=torch.channels_last)
        fl, gg = _nchw(flow).to(dt), _nchw(g).to(dt)
        leaves = [t.clone().requires_grad_() for t in (a, b, fl)]
        out = tcorr.warped_correlation_nchw(*leaves, scale, MD)
        assert torch.equal(out, tcorr.warped_correlation_nchw_plain(a, b, fl, scale, MD))
        out.backward(gg)
        want = tcorr.warped_correlation_nchw_backward_plain(a, b, fl, scale, gg, MD)
        for leaf, w in zip(leaves, want):
            assert leaf.grad.dtype == dt and torch.equal(leaf.grad, w)
        only = a.clone().requires_grad_()
        f2_, fl_ = b.clone(), fl.clone()
        tcorr.warped_correlation_nchw(only, f2_, fl_, scale, MD).backward(gg)
        assert torch.equal(only.grad, want[0]) and f2_.grad is None and fl_.grad is None
    a, b = (torch.from_numpy(t).requires_grad_() for t in (f1, f2))
    gl = torch.from_numpy(rng.randn(B, H, W, (2 * MD + 1) ** 2).astype(np.float32))
    tcorr.local_correlation(a, b, MD).backward(gl)
    want = tcorr.local_correlation_backward_plain(a.detach(), b.detach(), gl, MD)
    assert torch.equal(a.grad, want[0]) and torch.equal(b.grad, want[1])


def test_backward_wrappers_refuse_before_building():
    """The backward kernels' wrappers refuse CPU tensors; B2's forward
    refuses, with grad mode on, inputs that need a gradient (they go
    through `local_correlation`'s autograd function), before anything is
    built."""
    f = torch.zeros(1, 6, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        lc.local_correlation_backward_cuda(f, f, torch.zeros(1, 6, 8, 81), 4)
    nchw = f.permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        lc.warped_correlation_backward_cuda(nchw, nchw, torch.zeros(1, 2, 6, 8), 1.0,
                                           torch.zeros(1, 81, 6, 8), 4)
    with torch.enable_grad(), pytest.raises(NotImplementedError, match="autograd function"):
        lc.local_correlation_cuda(_OnCard(f, requires_grad=True), _OnCard(f), 4)
