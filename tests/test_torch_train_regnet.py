"""REGNet in train mode in the port against the JAX module: one training
step's depth loss, every parameter's gradient and the BN statistics.

Float64 on both sides, as JAX keeps it: the JAX module casts its features to
float32 for the correlation and the correlation back (`models/
depth_alternates.py:248-252`), and so does the port (the correlation's plain
version and its backward, `ops/camera.py::sweep_correlation_plain` /
`sweep_correlation_backward_plain`, in float32); the soft-argmax
regression is float32 on both sides. So the gradients agree to float32's
rounding of that one step: each to 1e-5 of its tensor's largest magnitude
(float64 elsewhere keeps the ReLUs of both sides on the same units, see
`test_torch_train_psnet.py`). 32x64 images, nlabel 8, a 3^3 pose grid;
the JAX variables go through the weight bridge, and the JAX gradients
through the same bridge into the port's parameter names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models import depth_alternates as jda
from deep_sfm_revisited_tpu.train import losses as jlosses
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models import depth_alternates as tda
from deep_sfm_revisited_tpu_torch.train import losses as tlosses
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)
B, H, W, NLABEL = 1, 32, 64, 8
OVER = {"depth.regnet_sample_num": 3}
LOSS = dict(nlabel=NLABEL, min_depth=1.0, rescale_depth=True, norm_target=0.6)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    tgt = (np.roll(ref, 2, axis=2)[:, None] + 0.05 * rng.randn(B, 1, H, W, 3)).astype(np.float32)
    K = np.array([[[45.0, 0, W / 2], [0, 45.0, H / 2], [0, 0, 1]]], np.float32)
    a = 0.02
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    pose = np.concatenate([R, [[0.3], [0.05], [0.9]]], 1)[None].astype(np.float32)
    gt = rng.uniform(1.5, 7.5, (B, H, W)).astype(np.float32)
    gt[rng.rand(B, H, W) < 0.6] = 0.0                       # sparse, as lidar GT
    unit = pose.copy()
    unit[..., 3] /= np.linalg.norm(pose[..., 3], axis=-1, keepdims=True)
    return ref, tgt, unit[:, None], K, gt, pose


def _f64(sd):
    return {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}


@pytest.fixture(scope="module")
def step_pair():
    """(JAX: loss, grads, stats; port: loss, grads, state) of one train step."""
    ref, tgt, pose, K, gt, pose_gt = _inputs()
    jnet = jda.REGNet(JConfig.kitti(NLABEL).override(**OVER).depth, dtype=jnp.float64)
    args = [jnp.asarray(a, jnp.float64) for a in (ref, tgt, pose, K, np.linalg.inv(K))]
    variables = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.float64),
        random_variables(jnet.init, jax.random.PRNGKey(0), *args, seed=1))

    def jloss(params):
        (d_init, d), upd = jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                      *args, train=True, mutable=["batch_stats"])
        loss, _ = jlosses.depth_training_loss(d_init, d, jnp.asarray(gt), jnp.asarray(pose_gt),
                                              **LOSS)
        return loss, upd["batch_stats"]

    (jl, jstats), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    entries = weights.regnet_entries("", "")
    jgrad = _f64(weights.convert({"params": jg, "batch_stats": jstats}, entries))
    jstats = _f64(weights.convert({"params": variables["params"], "batch_stats": jstats}, entries))

    tnet = tda.REGNet(TConfig.kitti(NLABEL).override(**OVER).depth).double()
    load_strict(tnet, _f64(weights.convert(variables, entries))).train()
    d_init, d = tnet(*(torch.from_numpy(a).double() for a in (ref, tgt, pose, K)))
    tl, _ = tlosses.depth_training_loss(d_init, d, torch.from_numpy(gt),
                                        torch.from_numpy(pose_gt), **LOSS)
    tl.backward()
    tgrad = {k: p.grad for k, p in tnet.named_parameters()}
    return (float(jl), jgrad, jstats), (float(tl.detach()), tgrad, tnet.state_dict())


# the loss (float32 regression on both sides) to 1e-6 relative
def test_train_loss_matches_jax(step_pair):
    (jl, _, _), (tl, _, _) = step_pair
    assert np.isfinite(tl) and tl > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


def test_every_parameter_gradient_matches_jax(step_pair):
    (_, jgrad, _), (_, tgrad, _) = step_pair
    assert set(tgrad) == {k for k in jgrad if not k.endswith(("running_mean", "running_var",
                                                              "num_batches_tracked"))}
    for k, g in tgrad.items():
        want = jgrad[k].numpy()
        assert g is not None, k
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=k)
    # the gradient reaches the feature net through the correlation's backward
    assert float(tgrad["feature_extraction.firstconv.0.0.weight"].abs().max()) > 0


def test_batch_statistics_match_jax(step_pair):
    """The running statistics after the step, by flax's rule (to 1e-6: the
    weight bridge stores JAX's in float32)."""
    (_, _, jstats), (_, _, tstats) = step_pair
    keys = [k for k in jstats if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(tstats[k].numpy(), jstats[k].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
