"""The port's training pieces against the JAX package, on the CPU.

Batch normalization in train mode (flax's running-statistics rule), the
depth loss, the milestone schedule, the optimizer's frozen subtrees, the
photometric noise and the image panes' colormaps. Inputs are made with
numpy from a seed and fed to both sides.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.train import losses as jlosses
from deep_sfm_revisited_tpu.train.trainer import milestone_schedule as jschedule
from deep_sfm_revisited_tpu.utils import viz as jviz
from deep_sfm_revisited_tpu_torch.config import SfMConfig
from deep_sfm_revisited_tpu_torch.models import submodules as tsub
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
from deep_sfm_revisited_tpu_torch.train import losses as tlosses
from deep_sfm_revisited_tpu_torch.train import trainer as ttrainer
from deep_sfm_revisited_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)
F32 = np.float32


def _flax_bn(x_nhwc, scale, bias, mean, var, steps):
    """flax's BatchNorm(momentum=0.9) in train mode, `steps` forwards in turn:
    [(output, running mean, running var)] after each."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    out = []
    for x in x_nhwc[:steps]:
        y, upd = bn.apply(variables, x, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        out.append((np.asarray(y), np.asarray(upd["batch_stats"]["mean"]),
                    np.asarray(upd["batch_stats"]["var"])))
    return out


# 2D and 3D maps, and a map of one value per channel (a 1x1 map at batch 1,
# which torch's own BN refuses in train mode)
BN_SHAPES = [(2, 6, 7, 5), (2, 4, 5, 6, 3), (1, 1, 1, 7)]


@pytest.mark.parametrize("shape", BN_SHAPES)
@pytest.mark.parametrize("steps", [1, 2])
def test_batchnorm_train_mode_matches_flax(shape, steps):
    """Output to 1e-5; running mean and var after each forward to 1e-6
    relative (flax: running = 0.9 running + 0.1 batch, biased variance)."""
    rng = np.random.RandomState(len(shape) + steps)
    C = shape[-1]
    xs = [(rng.randn(*shape) * 2 + 0.5).astype(F32) for _ in range(steps)]
    scale, bias = rng.uniform(0.5, 1.5, C).astype(F32), rng.randn(C).astype(F32)
    mean, var = rng.randn(C).astype(F32), rng.uniform(0.5, 2.0, C).astype(F32)
    want = _flax_bn([jnp.asarray(x) for x in xs], scale, bias, mean, var, steps)
    bn = (tsub.BatchNorm3d if len(shape) == 5 else tsub.BatchNorm2d)(C).train()
    with torch.no_grad():
        for p, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            p.copy_(torch.from_numpy(v))
    for x, (y, m, v) in zip(xs, want):
        got = bn(torch.from_numpy(np.moveaxis(x, -1, 1)))
        np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), y,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(), m, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(), v, rtol=1e-6, atol=1e-7)
    assert int(bn.num_batches_tracked) == steps


def test_checkpointed_recompute_updates_the_statistics_once():
    """Under `checkpointed` (depth.remat) the backward recomputes the
    forward without moving the running statistics a second time; outputs,
    gradients and statistics equal the plain run's."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 4, 3, 5, 6).astype(F32))
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        net = torch.nn.Sequential(tsub.convbn_3d(4, 3), torch.nn.ReLU(),
                                  tsub.convbn_3d(3, 2)).train()
        xi = x.clone().requires_grad_()
        y = tsub.checkpointed(net, xi) if remat else net(xi)
        y.square().sum().backward()
        runs.append((y.detach(), xi.grad, [b.clone() for b in net.buffers()],
                     [p.grad for p in net.parameters()]))
    (y0, g0, b0, p0), (y1, g1, b1, p1) = runs
    assert torch.equal(y0, y1)
    torch.testing.assert_close(g1, g0, rtol=1e-6, atol=1e-6)
    for a, b in zip(b0, b1):
        assert torch.equal(a, b)
    for a, b in zip(p0, p1):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    B, H, W = 4, 6, 8
    gt = rng.uniform(0.5, 12.0, (B, H, W)).astype(F32)
    gt[rng.rand(B, H, W) < 0.4] = 0.0          # sparse GT
    gt[0, 0, :3] = [0.99, 8.0, 8.01]           # either side of [min_depth, nlabel min_depth]
    init = rng.uniform(1, 8, (B, H, W)).astype(F32)
    depth = (init + rng.randn(B, H, W) * 2).astype(F32)
    pose = np.tile(np.eye(3, 4, dtype=F32), (B, 1, 1))
    # |t| = 0.1 (below the window), 0.6, 1.5, 3.0 (above it)
    pose[:, 2, 3] = [0.1, 0.6, 1.5, 3.0]
    return init, depth, gt, pose


@pytest.mark.parametrize("rescale,remask", [(True, False), (True, True), (False, False)])
def test_depth_training_loss_matches_jax(rescale, remask):
    args = _loss_inputs()
    kw = dict(nlabel=8, min_depth=1.0, rescale_depth=rescale, norm_target=0.6,
              min_train_scale=0.2, max_train_scale=2.0, init_weight=0.7, remask=remask)
    jl, jaux = jlosses.depth_training_loss(*(jnp.asarray(a) for a in args), **kw)
    tl, taux = tlosses.depth_training_loss(*(torch.from_numpy(a) for a in args), **kw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6, err_msg=k)


def test_smooth_l1_matches_jax():
    rng = np.random.RandomState(1)
    a, b = rng.randn(50).astype(F32) * 3, rng.randn(50).astype(F32)
    np.testing.assert_allclose(tlosses.smooth_l1(torch.from_numpy(a), torch.from_numpy(b)),
                               jlosses.smooth_l1(jnp.asarray(a), jnp.asarray(b)), rtol=1e-6)


@pytest.mark.parametrize("milestones,spe", [((3, 8), 5), ((1, 1, 4), 3), ((), 7)])
def test_milestone_schedule_matches_optax(milestones, spe):
    """The rate at every step around each boundary, as optax's schedule
    gives it (a boundary step already takes the decayed rate)."""
    j = jschedule(5e-4, milestones, 0.5, spe)
    t = ttrainer.milestone_schedule(5e-4, milestones, 0.5, spe)
    steps = sorted({0, 1} | {m * spe + d for m in milestones for d in (-1, 0, 1)}
                   | {10 * spe})
    for s in steps:
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-7, err_msg=f"step {s}")


SMALL = {"depth.nlabel": 8, "pose.num_hypotheses": 16, "pose.num_correspondences": 128}


@pytest.mark.parametrize("fix_flow,fix_depth", [(True, False), (False, False), (True, True)])
def test_optimizer_leaves_frozen_subtrees_out(fix_flow, fix_depth):
    cfg = SfMConfig.kitti().override(**SMALL, **{"train.fix_flownet": fix_flow,
                                                  "train.fix_depthnet": fix_depth})
    model = SFMNet(cfg, device="cpu")
    opt = ttrainer.build_optimizer(model, cfg)
    got = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, sub in (("flow", model.flow_estimator), ("depth", model.depth_estimator)):
        frozen = fix_flow if name == "flow" else fix_depth
        ids = {id(p) for p in sub.parameters()}
        assert (ids & got) == (set() if frozen else ids), name
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8


def test_image_noise():
    """One std ~ U(0, 3/255) per batch on ref and target, clipped to [-1, 1],
    reproducible from the generator; the other keys pass through."""
    rng = np.random.RandomState(2)
    batch = {"ref": torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(F32)),
             "target": torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(F32)),
             "depth_gt": torch.zeros(2, 16, 16)}
    a = ttrainer.add_image_noise(batch, torch.Generator().manual_seed(3))
    b = ttrainer.add_image_noise(batch, torch.Generator().manual_seed(3))
    assert a["depth_gt"] is batch["depth_gt"]
    for k in ("ref", "target"):
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], batch[k])
        assert float(a[k].abs().max()) <= 1.0
        inner = batch[k].abs() < 0.9
        assert float((a[k] - batch[k])[inner].std()) <= 3.0 / 255


def test_viz_matches_jax():
    """The image panes: flow RGB and the depth colormap (the port's numpy
    table of matplotlib's "bone") give the JAX package's bytes."""
    rng = np.random.RandomState(4)
    flow = (rng.randn(20, 30, 2) * 5).astype(F32)
    depth = rng.uniform(-5, 100, (40, 30)).astype(F32)
    depth[0, :5] = [0.0, 80.0, 40.0, 1e9, np.nan]
    np.testing.assert_array_equal(tviz.flow_to_rgb(flow), jviz.flow_to_rgb(flow))
    np.testing.assert_array_equal(tviz.depth_to_colormap(depth), jviz.depth_to_colormap(depth))
    np.testing.assert_array_equal(tviz.depth_to_colormap(depth, max_value=None),
                                  jviz.depth_to_colormap(depth, max_value=None))
