"""Depth training with the flow net trained (`train.fix_flownet=False`) on the
DICL and the PWC-DC route, against the JAX package's training objective,
at 128x128.

The JAX step (`trainer.py:230-258`) adds the flow loss of a batch that
carries `flow_gt` to the depth loss when the flow net trains; the RANSAC
pose is stop-gradient, so the flow net's gradient is that flow loss's
alone (DICL's multiscale loss, PWC-DC's sequence loss over its five
levels). Here, on each route, one port step (`train/trainer.py::Trainer.train_step`) on a batch with flow
GT and a valid mask, with the entropy sampler's and RANSAC's draws injected
(the JAX key split as tests/test_torch_train_step.py splits it; PWC-DC
gives no confidence, so the uniform sampler's, as
tests/test_torch_train_pwc.py splits it), is held
against JAX `_build_loss_fn` on the same weights, batch and draws, in
float32: every depth and sampler term to 1e-5 relative, the flow loss and
the total to 2e-4 (measured 4.9e-5 on DICL's route: in float32 the two
frameworks' DICL flows part by up to 1.5e-3 px at random weights,
tests/test_torch_train_dicl.py, and the flow loss is a mean of those
flows' L1 errors; PWC-DC's flows part by up to 1e-3 px,
tests/test_torch_pwcnet.py). The flow net's parameters are in Adam and
move, DICL's BN statistics move (PWC-DC has none), and its gradients are
those of the flow loss alone through the same weights (to 1e-6 of each
tensor's largest: the same graph, summed alike). The flow loss's gradient
against JAX's is tests/test_torch_flow_train.py's for DICL and
tests/test_torch_train_pwc_flow.py's for PWC-DC (in float64).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_pwc import _draws as _pwc_draws
from test_torch_train_step import OVER, _batch, _draws
from torch_parity import load_strict, random_variables

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models.sfmnet import SFMNet as JSFMNet
from deep_sfm_revisited_tpu.train.trainer import _build_loss_fn
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet as TSFMNet
from deep_sfm_revisited_tpu_torch.train.flow_trainer import flow_loss
from deep_sfm_revisited_tpu_torch.train.trainer import Trainer
from deep_sfm_revisited_tpu_torch.utils.weights import jax_params_to_torch

torch.set_num_threads(1)
B, H, W = 1, 128, 128
ESTIMATORS = ("DICL", "PWC")
# the sampler's and RANSAC's draws of each route (DICL's entropy sampler,
# PWC-DC's uniform one) and the flow net's parameter count with a gradient
DRAWS = {"DICL": _draws, "PWC": _pwc_draws}
MOVED = {"DICL": 200, "PWC": 120}


def _train_flow(estimator):
    return dict(OVER, **{"train.fix_flownet": False, "flow.estimator": estimator})


def _flow_batch():
    batch = {k: v.astype(np.float32) for k, v in _batch().items()}
    rng = np.random.RandomState(1)
    batch["flow_gt"] = (np.broadcast_to(np.array([3.0, 1.0]), (B, H, W, 2))
                        + rng.randn(B, H, W, 2)).astype(np.float32)
    batch["flow_valid"] = rng.rand(B, H, W) < 0.6
    return batch


@pytest.fixture(scope="module", params=ESTIMATORS)
def step(request):
    over = _train_flow(request.param)
    cfg_j, cfg_t = JConfig.kitti().override(**over), TConfig.kitti().override(**over)
    batch = _flow_batch()
    jnet = JSFMNet(cfg_j)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(lambda r, t, k: jnet.init(jax.random.PRNGKey(1), r, t, k,
                                                           key=jax.random.PRNGKey(2)),
                                 jb["ref"], jb["target"], jb["intrinsics"], seed=3)
    key = jax.random.PRNGKey(5)
    jloss, (jaux, _) = jax.jit(_build_loss_fn(jnet, cfg_j))(
        variables["params"], variables["batch_stats"], jb, key)

    model = TSFMNet(cfg_t, device="cpu")
    load_strict(model, jax_params_to_torch(variables, flow_estimator=request.param))
    alone = copy.deepcopy(model.flow_estimator).train()
    trainer = Trainer(model, cfg_t, steps_per_epoch=10)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = trainer.train_step(tb, noise=False, draws=DRAWS[request.param](key, cfg_t))
    # the flow loss alone through the flow net at the step's starting weights
    stack, _ = alone(torch.cat([tb["ref"], tb["target"]], dim=-1), all_iters=True)
    flow_loss(cfg_t.flow, stack, tb["flow_gt"], tb["flow_valid"]).backward()
    return dict(jloss=float(jloss), jaux={k: float(v) for k, v in jaux.items()},
                metrics={k: float(v) for k, v in metrics.items()}, model=model, alone=alone,
                before=before, trainer=trainer, estimator=request.param)


def test_step_loss_matches_jax(step):
    """The loss and each term of the JAX objective, the flow loss included."""
    m, jaux = step["metrics"], step["jaux"]
    assert "flow_loss" in jaux and set(m) == set(jaux) | {"loss"}
    assert np.isfinite(m["flow_loss"]) and m["flow_loss"] > 0
    np.testing.assert_allclose(m["loss"], step["jloss"], rtol=2e-4)
    for k, v in jaux.items():
        np.testing.assert_allclose(m[k], v, rtol=2e-4 if k == "flow_loss" else 1e-5, atol=1e-9,
                                   err_msg=k)


def test_step_trains_dicl_through_the_flow_loss(step):
    """Adam holds every parameter; the flow net's (DICL's or PWC-DC's)
    gradients are the flow loss's alone (RANSAC's inputs are detached),
    every flow-net parameter with a gradient moved, and DICL's BN
    statistics moved."""
    model, before, alone = step["model"], step["before"], step["alone"]
    held = {id(p) for g in step["trainer"].optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for p in model.parameters()}
    want = dict(alone.named_parameters())
    moved = 0
    for k, p in model.flow_estimator.named_parameters():
        assert p.grad is not None, k
        scale = float(want[k].grad.abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[k].grad.numpy(), rtol=0,
                                   atol=1e-6 * scale, err_msg=k)
        if p.grad.any():
            assert not torch.equal(p.detach(), before[f"flow_estimator.{k}"]), k
            moved += 1
    assert moved > MOVED[step["estimator"]]
    stats = [k for k in model.flow_estimator.state_dict() if k.endswith("running_mean")]
    for k in stats:
        assert not torch.equal(model.flow_estimator.state_dict()[k],
                               before[f"flow_estimator.{k}"]), k


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_depth_batches_without_flow_gt_leave_the_flow_loss_out(estimator):
    """A KITTI depth batch carries no flow GT: no flow-loss term, and the
    flow net gets no gradient from the depth loss."""
    cfg = TConfig.kitti().override(**_train_flow(estimator))
    model = TSFMNet(cfg, device="cpu", seed=2)
    trainer = Trainer(model, cfg, steps_per_epoch=10)
    batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in _batch(2).items()}
    m = trainer.train_step(batch, noise=False)
    assert "flow_loss" not in m and np.isfinite(float(m["loss"]))
    assert all(p.grad is None or not p.grad.any() for p in model.flow_estimator.parameters())
