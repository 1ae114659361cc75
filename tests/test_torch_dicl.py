"""The port's DICL flow and its helpers against the JAX package, in float32.

Weights go JAX -> bridge -> torch (BN statistics and biases perturbed), so
the DICL tables of the bridge, the deconvolution flip and the displacement
permutation of the cost smoothing are all on the path. 128x128 pairs (the
coarsest level must be even-sized: H, W multiples of 128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables, t2n

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models import dicl as jdicl
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models import dicl as tdicl
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)
B, H, W = 1, 128, 128


def _pair(seed=0):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    tgt = np.roll(ref, (2, 3), axis=(1, 2)) + 0.05 * rng.randn(B, H, W, 3)
    return np.concatenate([ref, tgt.astype(np.float32)], axis=-1)


@pytest.fixture(scope="module")
def dicl_pair():
    """JAX and port outputs (flow, entropy) of one forward, shared weights;
    the smoothing kernels are perturbed off identity so the displacement
    permutation matters."""
    pair = _pair()
    jnet = jdicl.DICLFlow(JConfig.kitti().flow)
    variables = random_variables(jnet.init, jax.random.PRNGKey(0), jnp.asarray(pair), seed=1)
    rng = np.random.RandomState(2)
    for li in range(5):  # identity (the JAX init) plus noise
        k = variables["params"][f"Conv_{2 * li}"]["kernel"]
        variables["params"][f"Conv_{2 * li}"]["kernel"] = (
            np.eye(k.shape[-1])[None, None] + 0.05 * rng.randn(*k.shape)).astype(np.float32)
    jflow, jent = jax.jit(jnet.apply)(variables, jnp.asarray(pair))
    tnet = tdicl.DICLFlow(TConfig.kitti().flow).eval()
    load_strict(tnet, weights.convert(variables, weights.dicl_entries("", "")))
    with torch.no_grad():
        tflow, tent = tnet(torch.from_numpy(pair))
    return (np.asarray(jflow), np.asarray(jent)), (t2n(tflow), t2n(tent))


# f32 through five levels of ~60 convolutions and four warps: flow to
# 1e-3 px (the JAX and torch convolutions sum in different orders)
def test_dicl_flow_matches_jax(dicl_pair):
    (jf, _), (tf, _) = dicl_pair
    assert tf.shape == (B, H, W, 2) and np.isfinite(tf).all()
    assert np.abs(jf).max() > 0.1  # a non-trivial flow field
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-3)


def test_dicl_entropy_matches_jax(dicl_pair):
    (_, je), (_, te) = dicl_pair
    assert te.shape == (B, H, W, 1)
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-4)


def test_dicl_raises_in_train_mode():
    """Train mode with autograd on no longer raises: the flow and its entropy
    carry a graph, and the flow's gradient reaches the U-net's first
    convolution through the five displacement volumes."""
    net = tdicl.DICLFlow(TConfig.kitti().flow).train()
    flow, ent = net(torch.from_numpy(_pair()))
    assert flow.requires_grad and ent.requires_grad
    flow.square().sum().backward()
    g = net.feature.conv_start[0].conv.weight.grad
    assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("mask_holes", [True, False])
def test_shifted_pairs_matches_jax(mask_holes):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 7, 4).astype(np.float32)
    y = rng.randn(2, 6, 7, 4).astype(np.float32)
    y[:, 2:4, 3:5] = 0.0  # a warp hole
    ref = np.asarray(jdicl.shifted_pairs(jnp.asarray(x), jnp.asarray(y), 2, mask_holes))
    got = tdicl.shifted_pairs(_nchw(x), _nchw(y), 2, mask_holes)
    np.testing.assert_array_equal(t2n(got.permute(0, 1, 3, 4, 2)), ref)


@pytest.mark.parametrize("trunc", [None, 1])
def test_flow_regression_and_entropy_match_jax(trunc):
    cost = (np.random.RandomState(4).randn(2, 49, 5, 6) * 2).astype(np.float32)
    ref = np.asarray(jdicl.flow_regression(jnp.asarray(cost), 3, truncated_size=trunc))
    got = tdicl.flow_regression(torch.from_numpy(cost), 3, truncated_size=trunc)
    np.testing.assert_allclose(t2n(got.permute(0, 2, 3, 1)), ref, rtol=1e-6, atol=1e-6)
    ent_ref = np.asarray(jdicl.flow_entropy(jnp.asarray(cost)))
    ent = tdicl.flow_entropy(torch.from_numpy(cost))
    np.testing.assert_allclose(t2n(ent.permute(0, 2, 3, 1)), ent_ref, rtol=1e-6, atol=1e-6)


def test_warp_flow_matches_jax():
    rng = np.random.RandomState(5)
    y = rng.randn(2, 12, 16, 32).astype(np.float32)
    flow = rng.uniform(-4, 4, (2, 12, 16, 2)).astype(np.float32)
    ref = np.asarray(jdicl.warp_flow(jnp.asarray(y), jnp.asarray(flow)))
    got = tdicl.warp_flow(_nchw(y), _nchw(flow))
    np.testing.assert_allclose(t2n(got.permute(0, 2, 3, 1)), ref, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def feature_pair():
    x = np.random.RandomState(6).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    jnet = jdicl.FeatureGA()
    variables = random_variables(jnet.init, jax.random.PRNGKey(7), jnp.asarray(x), seed=8)
    jout = [np.asarray(o) for o in jax.jit(jnet.apply)(variables, jnp.asarray(x))]
    tnet = tdicl.FeatureGA().eval()
    load_strict(tnet, weights.convert(variables, weights.featurega_entries("", "")))
    with torch.no_grad():
        tout = [t2n(o.permute(0, 2, 3, 1)) for o in tnet(_nchw(x))]
    return jout, tout


@pytest.mark.parametrize("level", [2, 3, 4, 5, 6])
def test_featurega_level_matches_jax(feature_pair, level):
    jout, tout = feature_pair
    j, t = jout[level - 2], tout[level - 2]
    assert t.shape == (1, 128 >> level, 128 >> level, 32)
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
