"""PSNet in train mode in the port against the JAX module, in float64.

The depth loss (`train/losses.py::depth_training_loss`) of one train-mode
forward and every parameter's gradient against `jax.value_and_grad` of the
JAX PSNet with `train=True` (SPP features per call, BN on batch statistics,
the gradient of the cost volume into the features), and the BN running
statistics the step leaves, with the port's `depth.remat` on and off (the
JAX module without remat: its remat recomputes the same values). The
port's volume gradient is the sweep backward's plain version here. 64x128
images, nlabel 8; the JAX variables go through the weight bridge, and the
JAX gradients through the same bridge into the port's parameter names.

Why float64 (both sides; the soft-argmax regression stays float32 on both,
as the modules write it): at random weights a float32 ReLU whose input
lies within rounding of zero switches between the two frameworks, and one
switched unit among the ~4000 positions a weight's gradient sums over moves
that gradient by ~1/sqrt(4000) of its largest element. A 1e-6 relative
change of the input image moves the port's own float32 gradients by up to
1.7e-2 of a tensor's largest element at these weights. In float64 both
sides take the same units, and the gradients agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models import psnet as jpsnet
from deep_sfm_revisited_tpu.train import losses as jlosses
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models import psnet as tpsnet
from deep_sfm_revisited_tpu_torch.train import losses as tlosses
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)
B, H, W, NLABEL = 1, 64, 128, 8
LOSS = dict(nlabel=NLABEL, min_depth=1.0, rescale_depth=True, norm_target=0.6)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    tgt = (np.roll(ref, 3, axis=2)[:, None]
           + 0.05 * rng.randn(B, 1, H, W, 3)).astype(np.float32)
    K = np.array([[[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]]], np.float32)
    a = 0.02
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    pose = np.concatenate([R, [[0.3], [0.05], [0.9]]], 1)[None].astype(np.float32)
    gt = rng.uniform(1.5, 7.5, (B, H, W)).astype(np.float32)
    gt[rng.rand(B, H, W) < 0.7] = 0.0                       # sparse, as lidar GT
    # PSNet sees the unit-norm translation; the loss rescales by the metric one
    unit = pose.copy()
    unit[..., 3] /= np.linalg.norm(pose[..., 3], axis=-1, keepdims=True)
    return ref, tgt, unit[:, None], K, gt, pose


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step's (loss, gradients, statistics), under the port's names."""
    ref, tgt, pose, K, gt, pose_gt = _inputs()
    jnet = jpsnet.PSNet(JConfig.kitti(NLABEL).override(**{"depth.remat": False}).depth,
                        norm_target=0.6, dtype=jnp.float64)
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
    entries = weights.psnet_entries("", "")
    jgrad = _f64(weights.convert({"params": jg, "batch_stats": jstats}, entries))
    jstats = _f64(weights.convert({"params": variables["params"], "batch_stats": jstats},
                                  entries))
    return float(jl), jgrad, jstats, _f64(weights.convert(variables, entries))


def _f64(sd):
    return {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}


@pytest.fixture(scope="module", params=[False, True], ids=["remat_off", "remat_on"])
def train_pair(request, jax_step):
    """(JAX: loss, grads, stats; port: loss, grads, stats) of one train step."""
    ref, tgt, pose, K, gt, pose_gt = _inputs()
    jl, jgrad, jstats, state = jax_step
    tnet = tpsnet.PSNet(TConfig.kitti(NLABEL).override(**{"depth.remat": request.param}).depth,
                        norm_target=0.6).double()
    load_strict(tnet, state).train()
    d_init, d = tnet(*(torch.from_numpy(a).double() for a in (ref, tgt, pose, K)))
    tl, _ = tlosses.depth_training_loss(d_init, d, torch.from_numpy(gt),
                                        torch.from_numpy(pose_gt), **LOSS)
    tl.backward()
    tgrad = {k: p.grad for k, p in tnet.named_parameters()}
    return (jl, jgrad, jstats), (float(tl.detach()), tgrad, tnet.state_dict())


# the loss (float32 regression on both sides) to 1e-6 relative, each
# gradient to 1e-5 of its tensor's largest magnitude (measured: 8e-7)
def test_train_loss_matches_jax(train_pair):
    (jl, _, _), (tl, _, _) = train_pair
    assert np.isfinite(tl) and tl > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


def test_every_parameter_gradient_matches_jax(train_pair):
    (_, jgrad, _), (_, tgrad, _) = train_pair
    assert set(tgrad) == {k for k in jgrad if not k.endswith(("running_mean", "running_var",
                                                              "num_batches_tracked"))}
    for k, g in tgrad.items():
        want = jgrad[k].numpy()
        assert g is not None, k
        # a 1x1 SPP branch at batch 1 normalizes to its bias: no gradient
        # reaches its convolution or BN scale on either side
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=k)


def test_batch_statistics_match_jax(train_pair):
    """The running statistics after the step: updated once (remat too), by
    flax's rule (to 1e-6: the weight bridge stores JAX's in float32)."""
    (_, _, jstats), (_, _, tstats) = train_pair
    keys = [k for k in jstats if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(tstats[k].numpy(), jstats[k].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
