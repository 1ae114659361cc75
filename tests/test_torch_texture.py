"""The texture sampler: `ops/flow_ops.py::texture_pseudo_entropy` and the
`pose.sampler="texture"` route of SFMNet, in the port against the JAX package.

The map to 1e-6 on seeded images (float32 on both sides: mean gray, edge
differences, a 5x5 box filter with zero padding, the smaller eigenvalue of
the structure tensor over its per-image maximum). The route on the slice's
128x128 scene (tests/test_torch_sfmnet.py's weights, draws and float64
candidates): the texture map replaces DICL's entropy as the sampler's
weight, so the confident-candidate counts are equal, the pose agrees to
1e-5 and the depth to 1e-4 relative, as on the entropy route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sfmnet import OVER, _draws, _inputs
from torch_parity import load_strict, random_variables, t2n

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models.sfmnet import SFMNet as JSFMNet
from deep_sfm_revisited_tpu.ops.flow_ops import texture_pseudo_entropy as jtex
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet as TSFMNet
from deep_sfm_revisited_tpu_torch.ops.flow_ops import texture_pseudo_entropy as ttex
from deep_sfm_revisited_tpu_torch.utils.weights import jax_params_to_torch

torch.set_num_threads(1)


@pytest.mark.parametrize("window", [5, 3])
@pytest.mark.parametrize("shape", [(2, 24, 40), (1, 17, 9)])
def test_texture_pseudo_entropy_matches_jax(shape, window):
    rng = np.random.RandomState(window + shape[1])
    img = rng.uniform(-1, 1, shape + (3,)).astype(np.float32)
    img[0, : shape[1] // 2] = 0.25                              # a flat, textureless band
    want = np.asarray(jtex(jnp.asarray(img), window))
    got = ttex(torch.from_numpy(img), window)
    assert got.shape == shape + (1,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert got.min() >= 0 and got.max() <= 1 and np.isclose(float(got.min()), 0.0, atol=1e-6)


def test_flat_image_is_all_untextured():
    got = ttex(torch.full((1, 8, 8, 3), 0.3))
    assert torch.equal(got, torch.ones(1, 8, 8, 1))


@pytest.fixture(scope="module")
def texture_run():
    ref, tgt, K, pose_gt = _inputs(2)
    over = dict(OVER, **{"pose.solve_dtype": "float64", "pose.sampler": "texture"})
    jcfg, tcfg = JConfig.kitti().override(**over), TConfig.kitti().override(**over)
    jnet = JSFMNet(jcfg)
    args = [jnp.asarray(a) for a in (ref, tgt, K)]
    variables = random_variables(lambda r, t, k: jnet.init(
        jax.random.PRNGKey(1), r, t, k, key=jax.random.PRNGKey(2)), *args, seed=8)
    key = jax.random.PRNGKey(9)
    jout = jax.jit(lambda v, r, t, k, kk: jnet.apply(v, r, t, k, key=kk))(variables, *args, key)
    tnet = TSFMNet(tcfg, device="cpu")
    load_strict(tnet, jax_params_to_torch(variables))
    tout = tnet(*(torch.from_numpy(a) for a in (ref, tgt, K)), draws=_draws(key, tcfg))
    return ({k: np.asarray(v) for k, v in jout.items() if v is not None},
            {k: t2n(v) for k, v in tout.items() if v is not None})


def test_texture_route_matches_jax(texture_run):
    jout, tout = texture_run
    assert set(tout) == set(jout) and "num_matches" in tout
    np.testing.assert_array_equal(tout["num_matches"], jout["num_matches"])
    np.testing.assert_array_equal(tout["inliers"], jout["inliers"])
    np.testing.assert_allclose(tout["pose"], jout["pose"], rtol=0, atol=1e-5)
    for which in ("depth_init", "depth"):
        np.testing.assert_allclose(tout[which], jout[which], rtol=1e-4, atol=1e-4)


def test_texture_route_trains():
    """One train-mode forward and backward on the texture route: PSNet gets
    gradients, the flow net none (it runs frozen)."""
    ref, tgt, K, pose_gt = _inputs(3)
    cfg = TConfig.kitti().override(**dict(OVER, **{"pose.sampler": "texture"}))
    net = TSFMNet(cfg, device="cpu", seed=1).train()
    out = net(*(torch.from_numpy(a) for a in (ref, tgt, K)), pose_gt=torch.from_numpy(pose_gt),
              generator=torch.Generator().manual_seed(0))
    out["depth"].mean().backward()
    assert out["num_matches"] is not None and torch.isfinite(out["depth"]).all()
    assert all(p.grad is None for p in net.flow_estimator.parameters())
    assert any(p.grad is not None and p.grad.abs().sum() > 0
               for p in net.depth_estimator.parameters())
