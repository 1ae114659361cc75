"""The port's PSNet and its building blocks against the JAX package, in float32.

The JAX variables (random, every BN statistic and bias off its init) go
through the port's weight bridge into the torch modules, so these tests
also hold the bridge's PSNet tables. 64x128 images, nlabel = 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables, t2n

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models import psnet as jpsnet
from deep_sfm_revisited_tpu.models import submodules as jsub
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models import psnet as tpsnet
from deep_sfm_revisited_tpu_torch.models import submodules as tsub
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)
B, H, W, NLABEL = 1, 64, 128, 8


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    tgt = np.roll(ref, 3, axis=2)[:, None] + 0.05 * rng.randn(B, 1, H, W, 3).astype(np.float32)
    K = np.array([[[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]]], np.float32)
    a = 0.02
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    pose = np.concatenate([R, [[0.3], [0.05], [0.9]]], 1)[None, None].astype(np.float32)
    return ref, tgt.astype(np.float32), pose, K


@pytest.fixture(scope="module")
def psnet_pair():
    """(JAX outputs, torch outputs) of one forward with shared weights."""
    cfg = JConfig.kitti(NLABEL).depth
    ref, tgt, pose, K = _inputs()
    K_inv = np.linalg.inv(K)
    jnet = jpsnet.PSNet(cfg, norm_target=0.6)
    args = [jnp.asarray(a) for a in (ref, tgt, pose, K, K_inv)]
    variables = random_variables(jnet.init, jax.random.PRNGKey(0), *args, seed=1)
    jout = jax.jit(jnet.apply)(variables, *args)
    tnet = tpsnet.PSNet(TConfig.kitti(NLABEL).depth, norm_target=0.6).eval()
    load_strict(tnet, weights.convert(variables, weights.psnet_entries("", "")))
    with torch.no_grad():
        tout = tnet(*(torch.from_numpy(a) for a in (ref, tgt, pose, K)))
    return [np.asarray(o) for o in jout], [t2n(o) for o in tout]


# f32 through ~40 convolutions: the two sides sum in different orders, so
# depth agrees to 1e-4 relative (depths here are 1..8 m)
@pytest.mark.parametrize("which", ["depth_init", "depth"])
def test_psnet_depth_matches_jax(psnet_pair, which):
    i = 0 if which == "depth_init" else 1
    (jo, to) = psnet_pair[0][i], psnet_pair[1][i]
    assert to.shape == (B, H, W) and np.isfinite(to).all()
    np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-4)


def test_psnet_raises_outside_the_slice():
    """D-packing (a TPU layout) is not ported and raises. A pose that needs a
    gradient no longer does (slice 7, POSENET): PSNet trains through it and
    the pose gets a finite, nonzero gradient through the plane sweep's pose
    gradient."""
    with pytest.raises(NotImplementedError):
        tpsnet.PSNet(TConfig.kitti(NLABEL).override(**{"depth.dpack": 4}).depth)
    net = tpsnet.PSNet(TConfig.kitti(NLABEL).depth)  # nn.Module starts in train mode
    ref, tgt, pose, K = (torch.from_numpy(np.concatenate([a, a])) for a in _inputs())
    depth_init, depth = net(ref, tgt, pose.requires_grad_(), K)
    (depth_init.mean() + depth.mean()).backward()
    assert pose.grad is not None and bool(torch.isfinite(pose.grad).all())
    assert float(pose.grad.abs().max()) > 0


@pytest.fixture(scope="module")
def spp_pair():
    x = np.random.RandomState(2).uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    jnet = jsub.SPPFeatureExtractor()
    variables = random_variables(jnet.init, jax.random.PRNGKey(3), jnp.asarray(x), seed=4)
    jout = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x)))
    tnet = tsub.SPPFeatureExtractor().eval()
    load_strict(tnet, weights.convert(variables, weights.spp_entries("", "")))
    with torch.no_grad():
        tout = t2n(tnet(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    return jout, tout


def test_spp_features_match_jax(spp_pair):
    """f32 through ~40 convolutions summed in another order: 1e-4 relative,
    and 1e-5 of the features' scale where a feature sits near zero (random
    weights grow the features to ~100 here)."""
    jout, tout = spp_pair
    assert tout.shape == (2, 16, 24, 32)
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-5 * np.abs(jout).max())


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("size", [(7, 13), (40, 24)])
def test_resize_bilinear_matches_jax(align, size):
    """Interpolation matrices (JAX) vs F.interpolate (port): 1e-5."""
    x = np.random.RandomState(5).randn(2, 16, 12, 3).astype(np.float32)
    ref = np.asarray(jsub.resize_bilinear(jnp.asarray(x), size, align_corners=align))
    got = t2n(tsub.resize_bilinear(torch.from_numpy(x), size, align_corners=align))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["disparity", "disparity_trunc", "depth"])
def test_soft_argmax_matches_jax(name):
    logits = np.random.RandomState(6).randn(2, 12, 5, 7).astype(np.float32) * 3
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    if name == "depth":
        ref, got = jsub.soft_argmax_depth(jp, 12, 0.5), tsub.soft_argmax_depth(tp, 12, 0.5)
    else:
        trunc = name == "disparity_trunc"
        ref = jsub.soft_argmax_disparity(jp, 12, trunc_soft=trunc)
        got = tsub.soft_argmax_disparity(tp, 12, trunc_soft=trunc)
    np.testing.assert_allclose(t2n(got), np.asarray(ref), rtol=1e-6, atol=1e-6)
