"""One whole training step of the port (`train/trainer.py::Trainer.train_step`)
against the JAX package's training objective, at 128x128.

The recipe's frozen-flow step: DICL in train mode without gradient, the
entropy sampler and five-point RANSAC on injected draws (the JAX key split
as `tests/test_torch_sfmnet.py` splits it; candidates solved in float64, so
the vote picks the same winner), PSNet in train mode, the depth loss,
backward, one Adam step. The loss and its terms are held against the JAX
`_build_loss_fn` on the same weights, batch and draws, in float32. DICL's
parameters must not move, its BN statistics must, and PSNet's parameters
after the step must be optax's Adam update, at the recipe's learning rate,
of the gradients the step computed (their agreement with JAX's gradients
is tests/test_torch_train_psnet.py's, in float64: in float32 a ReLU at
rounding distance from zero switches between frameworks, and Adam's first
step, about lr sign(g), would turn such a switch into a 2 lr difference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import load_strict, random_variables

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models.sfmnet import SFMNet as JSFMNet
from deep_sfm_revisited_tpu.train.trainer import _build_loss_fn, milestone_schedule
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet as TSFMNet
from deep_sfm_revisited_tpu_torch.train.trainer import Trainer
from deep_sfm_revisited_tpu_torch.utils.weights import jax_params_to_torch

torch.set_num_threads(1)
B, H, W = 1, 128, 128
OVER = {"depth.nlabel": 8, "pose.num_hypotheses": 16, "pose.ransac_iter": 1,
        "pose.num_correspondences": 128, "pose.score_subset": 32, "pose.score_topk": 64,
        "pose.polish_iters": 5, "pose.solve_dtype": "float64"}
STEPS_PER_EPOCH = 10


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (B, H, W, 3))
    tgt = np.roll(ref, (1, 3), axis=(1, 2)) + 0.05 * rng.randn(B, H, W, 3)
    a = 0.03
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    gt = rng.uniform(1.5, 7.5, (B, H, W))
    gt[rng.rand(B, H, W) < 0.7] = 0.0
    return {"ref": ref, "target": tgt,
            "intrinsics": np.array([[[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]]]),
            "pose_gt": np.concatenate([R, [[0.2], [0.0], [0.7]]], 1)[None],
            "depth_gt": gt}


def _draws(key, cfg):
    """The JAX composite's draws for `key` (entropy sampler: 4x candidates)."""
    pc = cfg.pose
    n_cand = 4 * pc.num_correspondences
    k_sample, k_ransac = jax.random.split(key)
    k_grid, k_gumbel = jax.random.split(k_sample)
    return {"jitter": torch.from_numpy(np.array(jax.random.uniform(
                k_grid, (B, n_cand, 2), jnp.float32, -0.5, 0.5))),
            "gumbel_u": torch.from_numpy(np.array(jax.random.uniform(
                k_gumbel, (B, n_cand), jnp.float32, 1e-12, 1.0))),
            "sample_idx": torch.from_numpy(np.array(jax.random.randint(
                k_ransac, (B, pc.num_hypotheses * pc.ransac_iter, 5), 0,
                pc.num_correspondences)))}


@pytest.fixture(scope="module")
def step():
    cfg_j, cfg_t = JConfig.kitti().override(**OVER), TConfig.kitti().override(**OVER)
    batch = {k: v.astype(np.float32) for k, v in _batch().items()}
    jnet = JSFMNet(cfg_j)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(lambda r, t, k: jnet.init(jax.random.PRNGKey(1), r, t, k,
                                                           key=jax.random.PRNGKey(2)),
                                 jb["ref"], jb["target"], jb["intrinsics"], seed=3)
    key = jax.random.PRNGKey(5)
    jloss, (jaux, _) = jax.jit(_build_loss_fn(jnet, cfg_j))(
        variables["params"], variables["batch_stats"], jb, key)

    model = TSFMNet(cfg_t, device="cpu")
    load_strict(model, jax_params_to_torch(variables))
    trainer = Trainer(model, cfg_t, steps_per_epoch=STEPS_PER_EPOCH)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    metrics = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                 noise=False, draws=_draws(key, cfg_t))
    return dict(jloss=float(jloss), jaux={k: float(v) for k, v in jaux.items()},
                metrics={k: float(v) for k, v in metrics.items()}, model=model,
                before=before, trainer=trainer, cfg=cfg_t)


def test_step_loss_matches_jax(step):
    """The loss and every metric of the JAX objective (depth terms, valid
    share, confident-candidate count, uniform-fallback share) to 1e-5
    (measured: 8e-7)."""
    m, jaux = step["metrics"], step["jaux"]
    assert np.isfinite(m["loss"]) and m["loss"] > 0
    np.testing.assert_allclose(m["loss"], step["jloss"], rtol=1e-5)
    assert set(m) == set(jaux) | {"loss"}
    for k, v in jaux.items():
        np.testing.assert_allclose(m[k], v, rtol=1e-5, atol=1e-9, err_msg=k)


def test_step_leaves_dicl_frozen(step):
    """DICL's parameters are bit-identical after the step and got no
    gradient; its BN running statistics moved (train-mode BN)."""
    model, before = step["model"], step["before"]
    for k, p in model.flow_estimator.named_parameters():
        assert torch.equal(p.detach(), before[f"flow_estimator.{k}"]), k
        assert p.grad is None, k
    stats = [k for k in model.flow_estimator.state_dict() if k.endswith("running_mean")]
    assert len(stats) > 50
    for k in stats:
        assert not torch.equal(model.flow_estimator.state_dict()[k],
                               before[f"flow_estimator.{k}"]), k


def test_step_is_optax_adam(step):
    """PSNet's parameters after the step are optax's Adam (the recipe's
    betas, eps 1e-8, the milestone schedule's rate at step 0) applied to the
    step's gradients, to 1e-7 (float32 rounding of the update); every
    PSNet parameter that got a gradient moved."""
    model, before, cfg = step["model"], step["before"], step["cfg"]
    t = cfg.train
    names = [k for k, _ in model.depth_estimator.named_parameters()]
    params = {k: jnp.asarray(before[f"depth_estimator.{k}"].numpy()) for k in names}
    grads = {k: jnp.asarray(p.grad.numpy()) for k, p in model.depth_estimator.named_parameters()}
    tx = optax.adam(milestone_schedule(t.lr, t.milestones, t.lr_decay, STEPS_PER_EPOCH),
                    b1=t.beta1, b2=t.beta2)
    want = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        grads, params)
    assert step["trainer"].step == 1
    for k, p in model.depth_estimator.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=0, atol=1e-7,
                                   err_msg=k)
        moved = not torch.equal(p.detach(), before[f"depth_estimator.{k}"])
        # a 1x1 SPP branch at batch 1 normalizes to its bias: no gradient
        assert moved or not p.grad.any(), k
