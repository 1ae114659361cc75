"""PoseNet (`models/posenet.py::PlainPose`) and the POSENET training step, in the port against JAX.

The forward in eval mode in float32 to 1e-5 (the running statistics of the
JAX variables, through the weight bridge's `plainpose_entries`), and in
train mode (batch statistics, flax's running-statistics rule).

The training step through PSNet into PoseNet, in float64 as slice 5's
PSNet step (tests/test_torch_train_psnet.py says why: float32 ReLUs at
random weights switch between the frameworks): PoseNet regresses rt from
the frame pair and a given flow and confidence (what the frozen DICL hands
it), `rt_to_pose(rt)` is PSNet's pose, and the loss is the depth loss plus
the pose loss. Every PoseNet parameter's gradient agrees with
`jax.value_and_grad` of the same composition to 8e-7 of its tensor's
largest magnitude, every PSNet one to slice 5's 1e-5; the pose gradient reaches PoseNet only through the plane
sweep (the port's `plane_sweep_volume_pose_grad_plain` here) and the pose
loss. Two things keep the comparison at float64's precision:
- PoseNet's head casts rt to float32 on both sides, as the modules write it,
  and the two casts can round one element one ulp apart; the plane sweep's
  gradient jumps where a sample crosses a tap (measured here: 0.3% of a
  component for a one-ulp rt change, in JAX and the port alike). So the
  port's rt takes JAX's value (within an ulp) and keeps its own gradient.
- JAX's `resize_bilinear` accumulates in float32 inside a float64 module
  (`preferred_element_type`), which perturbs PoseNet's flow and confidence
  inputs by ~1e-7 relative; the step feeds zeros (exact in both), and the
  forward tests above hold the resized inputs in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models import posenet as jposenet
from deep_sfm_revisited_tpu.models import psnet as jpsnet
from deep_sfm_revisited_tpu.ops.rotations import rt_to_pose as jrt_to_pose
from deep_sfm_revisited_tpu.train import losses as jlosses
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models import posenet as tposenet
from deep_sfm_revisited_tpu_torch.models import psnet as tpsnet
from deep_sfm_revisited_tpu_torch.ops.rotations import rt_to_pose as trt_to_pose
from deep_sfm_revisited_tpu_torch.train import losses as tlosses
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)
B, H, W, NLABEL = 2, 64, 96, 8
LOSS = dict(nlabel=NLABEL, min_depth=1.0, rescale_depth=True, norm_target=0.6)
POSE_ENTRIES = weights.plainpose_entries("", "")
DEPTH_ENTRIES = weights.psnet_entries("", "")


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    tgt = (np.roll(ref, 3, axis=2) + 0.05 * rng.randn(B, H, W, 3)).astype(np.float32)
    flow = (rng.randn(B, H, W, 2) * 2.0).astype(np.float32)
    conf = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    K = np.broadcast_to(np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]],
                                 np.float32), (B, 3, 3)).copy()
    a = 0.02
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    pose_gt = np.stack([np.concatenate([R, [[0.3], [0.05], [0.9 + 0.1 * b]]], 1)
                        for b in range(B)]).astype(np.float32)
    gt = rng.uniform(1.5, 7.5, (B, H, W)).astype(np.float32)
    gt[rng.rand(B, H, W) < 0.7] = 0.0
    return ref, tgt, flow, conf, K, gt, pose_gt


def _f64(sd):
    return {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}


@pytest.mark.parametrize("train", [False, True])
def test_plainpose_forward_matches_jax(train):
    ref, tgt, flow, conf, *_ = _inputs(1)
    jnet = jposenet.PlainPose()
    args = [jnp.asarray(a) for a in (flow, ref, tgt, conf)]
    variables = random_variables(jnet.init, jax.random.PRNGKey(0), *args, seed=2)
    if train:
        want, upd = jnet.apply(variables, *args, train=True, mutable=["batch_stats"])
    else:
        want = jnet.apply(variables, *args)
    tnet = load_strict(tposenet.PlainPose(), weights.convert(variables, POSE_ENTRIES))
    tnet.train(train)
    with torch.no_grad():
        got = tnet(*(torch.from_numpy(a) for a in (flow, ref, tgt, conf)))
    assert got.shape == (B, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.vector_norm(got[:, 3:], dim=-1).numpy(), 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if train:
        stats = weights.convert({"params": variables["params"],
                                 "batch_stats": upd["batch_stats"]}, POSE_ENTRIES)
        for k, v in tnet.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=k)


def test_plainpose_without_confidence_takes_zeros():
    ref, tgt, flow, conf, *_ = _inputs(2)
    net = tposenet.PlainPose().eval()
    args = [torch.from_numpy(a) for a in (flow, ref, tgt)]
    with torch.no_grad():
        torch.testing.assert_close(net(*args), net(*args, torch.zeros_like(torch.from_numpy(conf))))


@pytest.fixture(scope="module")
def steps():
    """(JAX: loss, gradients; port: loss, gradients), under the port's names."""
    ref, tgt, flow, conf, K, gt, pose_gt = _inputs()
    flow, conf = np.zeros_like(flow), np.zeros_like(conf)
    jpose = jposenet.PlainPose(dtype=jnp.float64)
    jdepth = jpsnet.PSNet(JConfig.kitti(NLABEL).override(**{"depth.remat": False}).depth,
                          norm_target=0.6, dtype=jnp.float64)
    f64 = [jnp.asarray(a, jnp.float64) for a in (flow, ref, tgt, conf, K)]
    jflow, jref, jtgt, jconf, jK = f64
    pvars = random_variables(jpose.init, jax.random.PRNGKey(0), jflow, jref, jtgt, jconf,
                             seed=3)
    dvars = random_variables(
        jdepth.init, jax.random.PRNGKey(1), jref, jtgt[:, None],
        jnp.zeros((B, 1, 3, 4), jnp.float64).at[..., :3, :3].set(jnp.eye(3)), jK,
        jnp.linalg.inv(jK), seed=4)
    pvars, dvars = (jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64), v)
                    for v in (pvars, dvars))

    def jloss(pp, dp):
        rt, _ = jpose.apply({"params": pp, "batch_stats": pvars["batch_stats"]}, jflow, jref, jtgt,
                            jconf, train=True, mutable=["batch_stats"])
        pose = jrt_to_pose(rt)
        (d_init, d), _ = jdepth.apply({"params": dp, "batch_stats": dvars["batch_stats"]}, jref,
                                      jtgt[:, None], pose[:, None], jK, jnp.linalg.inv(jK),
                                      train=True, mutable=["batch_stats"])
        loss, _ = jlosses.depth_training_loss(d_init, d, jnp.asarray(gt), jnp.asarray(pose_gt),
                                              **LOSS)
        return loss + jlosses.pose_regression_loss(rt, jnp.asarray(pose_gt)), rt

    (jl, jrt), (jgp, jgd) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        pvars["params"], dvars["params"])
    jgrad = {**{f"posenet.{k}": v for k, v in _f64(weights.convert(
                {"params": jgp, "batch_stats": pvars["batch_stats"]}, POSE_ENTRIES)).items()},
             **{f"depth.{k}": v for k, v in _f64(weights.convert(
                 {"params": jgd, "batch_stats": dvars["batch_stats"]}, DEPTH_ENTRIES)).items()}}

    tpose = load_strict(tposenet.PlainPose().double(), _f64(weights.convert(pvars, POSE_ENTRIES)))
    tdepth = load_strict(tpsnet.PSNet(TConfig.kitti(NLABEL).depth, norm_target=0.6).double(),
                         _f64(weights.convert(dvars, DEPTH_ENTRIES)))
    tpose.train()
    tdepth.train()
    tref, ttgt, tflow, tconf, tK = (torch.from_numpy(a).double() for a in (ref, tgt, flow, conf, K))
    rt = tpose(tflow, tref, ttgt, tconf)
    jrt = torch.from_numpy(np.asarray(jrt))
    assert rt.dtype == jrt.dtype == torch.float32
    torch.testing.assert_close(rt, jrt, rtol=2.5e-7, atol=1e-9)
    rt = rt + (jrt - rt).detach()                  # JAX's value, the port's gradient
    d_init, d = tdepth(tref, ttgt[:, None], trt_to_pose(rt)[:, None], tK)
    tl, _ = tlosses.depth_training_loss(d_init, d, torch.from_numpy(gt), torch.from_numpy(pose_gt),
                                        **LOSS)
    tl = tl + tlosses.pose_regression_loss(rt, torch.from_numpy(pose_gt))
    tl.backward()
    tgrad = {**{f"posenet.{k}": p.grad for k, p in tpose.named_parameters()},
             **{f"depth.{k}": p.grad for k, p in tdepth.named_parameters()}}
    return (float(jl), jgrad), (float(tl.detach()), tgrad)


def test_posenet_step_loss_matches_jax(steps):
    (jl, _), (tl, _) = steps
    assert np.isfinite(tl) and tl > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


def test_posenet_step_gradients_match_jax(steps):
    """PoseNet's gradients to 8e-7 of each tensor's largest magnitude
    (measured: 1.4e-7), PSNet's to slice 5's bound for them, 1e-5
    (tests/test_torch_train_psnet.py; measured here: 1.8e-6, in the context
    net, behind PSNet's float32 soft-argmax). A PoseNet conv bias feeds a
    train-mode BN, which subtracts it again: its gradient is zero but for
    rounding, on both sides, so it is held to zero against the step's
    largest gradient instead."""
    (_, jgrad), (_, tgrad) = steps
    assert any(k.startswith("posenet.") for k in tgrad)
    scale = max(float(v.abs().max()) for v in jgrad.values())
    for k, g in tgrad.items():
        want = jgrad[k].numpy()
        assert g is not None, k
        if k.startswith("posenet.") and k.endswith(".0.bias"):
            assert max(np.abs(want).max(), float(g.abs().max())) < 1e-9 * scale, k
            continue
        bound = 8e-7 if k.startswith("posenet.") else 1e-5
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=bound * np.abs(want).max(),
                                   err_msg=k)
    assert tgrad["posenet.pose_reg.weight"].abs().max() > 0
