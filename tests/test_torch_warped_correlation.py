"""PWC-DC's warped correlation in the port against the JAX package.

`ops/correlation.py::warped_correlation` is PWC-DC's flow warp and
correlation of one level under JAX's NHWC float32 contract: on CUDA tensors
the warped correlation's kernel (`csrc/warped_corr.cu`) between permutes,
on the CPU its plain version `warped_correlation_plain`, the correlation of
f1 with f2 sampled at
grid + flow * scale by the gather's plain version, in f2's dtype, both cast
to float32. Here the plain version is held against the JAX package's
`local_correlation(f1.astype(f32), warp_flow(f2, flow).astype(f32), md)` on
the XLA path and through both Pallas kernels in interpret mode, on inputs
made with numpy from a seed: float32 and bfloat16 features, C not a
multiple of 4, md 4 (and 2), flows that push samples off the frame and just
past its border. PWC-DC's forward goes through its NCHW form
(`warped_correlation_nchw`, `tests/test_torch_warped_nchw.py`) at levels
5..2 and matches the JAX network. The kernel itself runs on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).

Tolerances: float32 to 1e-6 absolute (correlations of order 1; the two
frameworks round the blend alike and sum C products in other orders). In
bfloat16 a warped value may land on the neighbouring bf16 value where the
two frameworks' float32 blends differ by an ulp at a rounding boundary: so
per output element 2^-8 times the correlation of |f1| with |warped f2|,
plus 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables, t2n

from deep_sfm_revisited_tpu.config import FlowConfig as JFlow
from deep_sfm_revisited_tpu.models import dicl as jdicl
from deep_sfm_revisited_tpu.models.pwcnet import PWCDCNet as JPWC
from deep_sfm_revisited_tpu.ops.correlation import local_correlation as j_corr
from deep_sfm_revisited_tpu.ops.pallas.local_corr import local_correlation_pallas
from deep_sfm_revisited_tpu.ops.pallas.sweep_warp import bilinear_sample_pallas
from deep_sfm_revisited_tpu_torch.config import FlowConfig as TFlow
from deep_sfm_revisited_tpu_torch.models import pwcnet as tpwc
from deep_sfm_revisited_tpu_torch.ops import correlation as tcorr
from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)

# (B, H, W, C): C not a multiple of 4, odd H and W, a batch of two
SHAPES = [(1, 9, 13, 6), (2, 7, 11, 5), (1, 12, 16, 8)]


def _inputs(shape, seed, flow_kind):
    """f1, f2 (B, H, W, C) float32 and a flow (B, 2, H, W) float32 of a few
    pixels; "off" also sends a band of samples frames away and a row just
    past the last one and a column just before the first."""
    B, H, W, C = shape
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    flow = rng.uniform(-2.5, 2.5, (B, 2, H, W)).astype(np.float32)
    if flow_kind == "off":
        flow[:, 0, :, -2:] = 3.0 * W
        flow[:, 1, -1, :] = 1.5
        flow[:, 0, :, 0] = -0.401
    return f1, f2, flow


def _to(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _tolerance(f1, f2, flow, scale, md, dtype):
    """Elementwise: exact-sum noise in float32; one bf16 rounding of each
    warped value in bfloat16 (module docstring)."""
    if dtype == torch.float32:
        return 1e-6
    grid = torch.stack(torch.meshgrid(torch.arange(f2.shape[1], dtype=torch.float32),
                                      torch.arange(f2.shape[2], dtype=torch.float32),
                                      indexing="ij")[::-1])
    coords = (grid[None] + torch.from_numpy(flow) * scale).permute(0, 2, 3, 1)
    from deep_sfm_revisited_tpu_torch.ops.camera import bilinear_sample_plain
    warped = bilinear_sample_plain(_to(f2, dtype), coords).float()
    bound = tcorr.local_correlation_plain(_to(f1, torch.float32).abs(), warped.abs(), md)
    return 2.0 ** -8 * bound.numpy() + 1e-6


def _jax_warp_corr(f1, f2, flow, scale, md, dtype, pallas=False):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jf2 = jnp.asarray(f2).astype(jd)
    jflow = jnp.asarray(np.moveaxis(flow, 1, -1)) * jnp.float32(scale)   # (B, H, W, 2)
    if pallas:
        B, H, W, _ = f2.shape
        gy, gx = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32),
                              indexing="ij")
        coords = jnp.stack([gx, gy], axis=-1)[None] + jflow
        warped = bilinear_sample_pallas(jf2, coords, interpret=True)
        return np.asarray(local_correlation_pallas(
            jnp.asarray(f1), warped.astype(jnp.float32), md, 4, True))
    warped = jdicl.warp_flow(jf2, jflow)
    return np.asarray(j_corr(jnp.asarray(f1), warped.astype(jnp.float32), md))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("flow_kind", ["flow", "off"])
@pytest.mark.parametrize("shape", SHAPES, ids=["b1_9x13c6", "b2_7x11c5", "b1_12x16c8"])
def test_plain_matches_xla(shape, flow_kind, dtype):
    """md 4 at PWC-DC's level-2 scale (5.0), against JAX's warp_flow and
    local_correlation."""
    f1, f2, flow = _inputs(shape, seed=shape[-1] + len(flow_kind), flow_kind=flow_kind)
    scale, md = 5.0 / 4, 4      # a few px of flow times a level's scale
    ref = _jax_warp_corr(f1, f2, flow, scale, md, dtype)
    got = tcorr.warped_correlation(_to(f1, torch.float32), _to(f2, dtype), _to(flow, torch.float32),
                                   scale, md)
    assert got.dtype == torch.float32 and got.shape == shape[:3] + (81,)
    err = np.abs(got.numpy() - ref)
    assert (err <= _tolerance(f1, f2, flow, scale, md, dtype)).all(), err.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("md", [2, 4])
def test_plain_matches_pallas_interpret(md, dtype):
    """Both Pallas kernels in interpret mode, the gather then the
    correlation, as the JAX package's own tests run them."""
    shape = (1, 12, 16, 6)
    f1, f2, flow = _inputs(shape, seed=3 + md, flow_kind="off")
    scale = 0.625
    ref = _jax_warp_corr(f1, f2, flow, scale, md, dtype, pallas=True)
    got = tcorr.warped_correlation_plain(_to(f1, torch.float32), _to(f2, dtype),
                                         _to(flow, torch.float32), scale, md)
    err = np.abs(got.numpy() - ref)
    assert (err <= _tolerance(f1, f2, flow, scale, md, dtype)).all(), err.max()


def test_plain_is_the_composition():
    """The plain version is the composition PWC-DC ran before, bit for bit:
    warp_flow(f2, flow * scale) with the gather's plain version, the float32
    casts, then the correlation."""
    from deep_sfm_revisited_tpu_torch.models import dicl as tdicl
    from deep_sfm_revisited_tpu_torch.ops.camera import bilinear_sample_plain

    f1, f2, flow = _inputs((2, 7, 11, 5), seed=9, flow_kind="off")
    for dtype in (torch.float32, torch.bfloat16):
        t1, t2, tf = _to(f1, torch.float32), _to(f2, dtype), _to(flow, torch.float32)
        warped = tdicl.warp_flow(t2.permute(0, 3, 1, 2), tf * 2.5, bilinear_sample_plain)
        want = tcorr.local_correlation_plain(t1, warped.permute(0, 2, 3, 1).float(), 4)
        assert torch.equal(tcorr.warped_correlation(t1, t2, tf, 2.5, 4), want)


def test_dispatcher_and_wrapper_refusals():
    """Other devices raise; the kernel's wrapper refuses CPU tensors and
    wrong dtypes, shapes, layouts and md before anything is built."""
    f = torch.zeros(1, 4, 4, 4, device="meta")
    with pytest.raises(NotImplementedError):
        tcorr.warped_correlation(f, f, torch.zeros(1, 2, 4, 4, device="meta"), 1.0, 1)
    f1 = torch.zeros(1, 6, 8, 4)
    flow = torch.zeros(1, 2, 6, 8)
    with pytest.raises(ValueError, match="CUDA"):
        local_corr.warped_correlation_cuda(f1, f1.bfloat16(), flow, 1.0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        local_corr.local_correlation_cuda(f1, f1, 4)


# PWC-DC at a small size, as tests/test_torch_pwcnet.py holds it
B, H, W = 1, 64, 64


@pytest.fixture(scope="module")
def pwc_pair():
    rng = np.random.RandomState(4)
    pair = rng.uniform(-1, 1, (B, H, W, 6)).astype(np.float32)
    pair[..., 3:] = np.roll(pair[..., :3], (2, 1), axis=(1, 2)) + 0.05 * rng.randn(B, H, W, 3)
    jnet = JPWC(JFlow(estimator="PWC"))
    variables = random_variables(lambda p: jnet.init(jax.random.PRNGKey(0), p),
                                 jnp.asarray(pair), seed=2)
    jflow, _ = jax.jit(jnet.apply)(variables, jnp.asarray(pair))
    sd = weights.convert(variables, weights.pwc_entries(t="", f=""))
    tnet = load_strict(tpwc.PWCDCNet(TFlow(estimator="PWC")), sd).eval()
    return pair, np.asarray(jflow), tnet


def test_pwcnet_runs_the_warped_correlation_and_matches_jax(pwc_pair, monkeypatch):
    """Levels 5..2 call `warped_correlation_nchw` (one kernel a level on
    the card, on the network's NCHW features) at the upstream scales
    0.625..5, level 6 `local_correlation`; the flow matches JAX's to 1e-3
    px after the x20 (float32 convolutions, sums in other orders)."""
    pair, jflow, tnet = pwc_pair
    calls = {"warped": [], "plain": 0}
    warped, plain = tpwc.warped_correlation_nchw, tpwc.local_correlation

    def spy_warped(f1, f2, flow, scale, md):
        calls["warped"].append((tuple(f1.shape), scale, md))
        return warped(f1, f2, flow, scale, md)

    def spy_plain(f0, f1, md):
        calls["plain"] += 1
        return plain(f0, f1, md)

    monkeypatch.setattr(tpwc, "warped_correlation_nchw", spy_warped)
    monkeypatch.setattr(tpwc, "local_correlation", spy_plain)
    with torch.no_grad():
        tflow, _ = tnet(torch.from_numpy(pair))
    assert calls["plain"] == 1
    assert [(s[2:4], sc, md) for s, sc, md in calls["warped"]] == [
        ((2, 2), 0.625, 4), ((4, 4), 1.25, 4), ((8, 8), 2.5, 4), ((16, 16), 5.0, 4)]
    assert np.abs(jflow).max() > 1e-2        # not a vacuous comparison
    np.testing.assert_allclose(t2n(tflow), jflow, rtol=0, atol=1e-3)
