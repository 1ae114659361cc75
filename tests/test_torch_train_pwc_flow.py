"""PWC-DC flow pretraining in the port (`train/flow_trainer.py`, `cli.main
--train-flow --override flow.estimator=PWC`) against the JAX package's.

- Two PWC-DC flow steps at 64x128, b = 2, against JAX `make_flow_train_step`
  with `create_flow_state`'s optimizer (clipping, AdamW with weight decay
  1e-5, the one-cycle schedule), in float64 on both sides: RAFT's sequence
  loss (gamma 0.8, max_flow 400) over the `all_iters` stack of PWC-DC's
  five levels, and the EPE of the last. Both packages compute the
  correlations in float32 (PWC-DC casts its features, JAX
  `models/pwcnet.py:125-131`), so the float64 steps carry float32 noise
  there. Held: the loss and EPE of both steps; the clipped gradient of every
  parameter in the first step (0.1 of it is both AdamWs' first moment);
  the parameters after the two steps against optax's AdamW applied to the
  port's own clipped gradients.
- `cli.main --train-flow` with PWC-DC on a rendered KITTI flow tree whose
  pairs /8 padding leaves at 128x192: an epoch of two steps, the
  validation's EPE and Fl-all, a checkpoint that `--pretrained-flow`
  restores into an SFMNet built with `flow.estimator=PWC`; and the size
  rule, refused before the first step, on a tree whose pairs are not /64.

Tolerances: the loss and EPE to 1e-6 relative (measured below 1e-7: the
float32 correlations round in other orders); the first step's gradient to
1e-5 of the largest gradient element, 1 - cosine <= 1e-10; the second
step's loss and EPE to 1e-5 (Adam's first update is about lr sign(g), so a
gradient within the noise of zero moves its parameter up to 2 lr apart);
the parameters against optax on the port's own gradients to 1e-10
(float64; optax rounds its rate to float32).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import load_strict, random_variables

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models.pwcnet import PWCDCNet as JPWC
from deep_sfm_revisited_tpu.train import flow_trainer as jft
from deep_sfm_revisited_tpu.train.trainer import TrainState
from deep_sfm_revisited_tpu_torch import cli
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_flow_tree
from deep_sfm_revisited_tpu_torch.models.pwcnet import PWCDCNet as TPWC
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
from deep_sfm_revisited_tpu_torch.train import flow_trainer as tft
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(2)
B, H, W = 2, 64, 128
LR, TOTAL, STEPS = 4e-4, 40, 2
PWC = {"flow.estimator": "PWC"}


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        ref = rng.uniform(-1, 1, (B, H, W, 3))
        tgt = np.roll(ref, (2, 3), axis=(1, 2)) + 0.05 * rng.randn(B, H, W, 3)
        gt = np.broadcast_to(np.array([3.0, 2.0]), (B, H, W, 2)) + rng.randn(B, H, W, 2)
        out.append({"ref": ref, "target": tgt, "flow_gt": gt.astype(np.float32),
                    "flow_valid": rng.rand(B, H, W) < 0.7})
    return out


@pytest.fixture(scope="module")
def steps():
    jcfg = JConfig.kitti().override(**PWC).flow
    jnet = JPWC(jcfg, dtype=jnp.float64)
    pair = jnp.zeros((B, H, W, 6), jnp.float64)
    variables = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.float64),
        random_variables(jnet.init, jax.random.PRNGKey(0), pair, seed=1))
    sched = optax.linear_onecycle_schedule(TOTAL, LR, pct_start=0.05)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-5))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats={}, opt_state=tx.init(variables["params"]), tx=tx)
    step = jft.make_flow_train_step(jnet, jcfg)
    entries = weights.pwc_entries(t="", f="")
    cfg = TConfig.kitti().override(**PWC, **{"train.lr": LR, "train.mixed_prec": False})
    net = load_strict(TPWC(cfg.flow), weights.convert(variables, entries)).double()
    trainer = tft.FlowTrainer(net, cfg, total_steps=TOTAL)
    params = dict(net.named_parameters())
    before = {k: v.detach().clone() for k, v in params.items()}
    jm, tm, grads = [], [], []
    for i, b in enumerate(_batches()):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tm.append({k: float(v) for k, v in trainer.train_step(
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}).items()})
        grads.append({k: p.grad.clone() for k, p in params.items()})   # clipped
        if i == 0:
            mu = state.opt_state[1][0].mu
            jgrad = weights.convert({"params": jax.tree_util.tree_map(lambda v: v / 0.1, mu)},
                                    entries)
    adamw = optax.adamw(sched, weight_decay=1e-5)

    @jax.jit
    def update(g, opt, p):
        upd, opt = adamw.update(g, opt, p)
        return optax.apply_updates(p, upd), opt

    p = {k: jnp.asarray(before[k].numpy()) for k in params}
    opt = adamw.init(p)
    for g in grads:
        p, opt = update({k: jnp.asarray(v.numpy()) for k, v in g.items()}, opt, p)
    return dict(jm=jm, tm=tm, trainer=trainer, before=before, jgrad=jgrad, grads=grads, want=p)


def test_pwc_flow_steps_loss_and_epe_match_jax(steps):
    assert steps["trainer"].step == STEPS
    for i, (t, j) in enumerate(zip(steps["tm"], steps["jm"])):
        assert set(t) == set(j) == {"loss", "epe"}
        for k in j:
            assert np.isfinite(t[k]) and t[k] > 0
            np.testing.assert_allclose(t[k], j[k], rtol=1e-6 if i == 0 else 1e-5,
                                       err_msg=f"step {i} {k}")


def test_pwc_flow_step_gradient_matches_jax(steps):
    """The first step's clipped gradient of every parameter against JAX's;
    every one is non-zero (the gradient reaches each level through both
    correlations and the warps' flows)."""
    got, want = steps["grads"][0], steps["jgrad"]
    assert len(got) == 126 and set(got) == set(want)
    largest = max(float(want[k].abs().max()) for k in got)
    for k, g in got.items():
        assert g.abs().max() > 0, k
        np.testing.assert_allclose(g.numpy(), want[k].double().numpy(), rtol=0,
                                   atol=1e-5 * largest, err_msg=k)
    a = torch.cat([g.flatten() for g in got.values()])
    b = torch.cat([want[k].double().flatten() for k in got])
    assert float(1 - a @ b / (a.norm() * b.norm())) <= 1e-10


def test_pwc_flow_steps_parameters_are_optax_adamw(steps):
    """Every parameter after the two steps is optax's AdamW of the port's
    clipped gradients, and every one moved."""
    net, before, want = steps["trainer"].model, steps["before"], steps["want"]
    for k, p in net.named_parameters():
        assert not torch.equal(p.detach(), before[k]), k
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-10, err_msg=k)


TINY = {"flow.estimator": "PWC", "train.mixed_prec": False}


def _argv(root, out, *extra):
    return ["--data", root, "--cfg", "kitti", "--train-flow", "--flow-dataset", "kitti",
            "--out", str(out), "--workers", "2", "-b", "2", *extra,
            "--override", *[f"{k}={v}" for k, v in TINY.items()]]


def test_cli_train_flow_pwc_epoch_and_pretrained_flow(tmp_path):
    """One epoch of two steps at b = 2 on 64x128 crops of a 4-pair tree
    rendered at 128x192; finite loss and training EPE, the validation's EPE
    and Fl-all over the four pairs; PWC-DC's parameters moved from the
    seeded ones; `--pretrained-flow` restores every PWC-DC tensor into an
    SFMNet with `flow.estimator=PWC` and leaves PSNet untouched."""
    root = str(tmp_path / "kitti_flow")
    write_kitti_flow_tree(root, n_pairs=4, hw=(128, 192), seed=1)
    out = tmp_path / "out"
    history = cli.main(_argv(root, out, "--flow-crop", "64", "128", "--epochs", "1"),
                       device="cpu")
    assert len(history) == 1 and history[0]["step"] == 2 and history[0]["n"] == 4
    for k in ("train_loss", "train_epe", "epe", "f1_all"):
        assert math.isfinite(history[0][k]) and history[0][k] >= 0, k
    ckpt = out / "kitti_flow" / "ckpt"
    stored = torch.load(ckpt / "0.pt", weights_only=True)
    assert stored["config"]["flow"]["estimator"] == "PWC"
    cfg = TConfig.kitti().override(**TINY)
    fresh = tft.build_flow_model(cfg.flow, seed=cfg.train.seed).state_dict()
    assert set(stored["model"]) == set(fresh) and len(fresh) == 126
    assert all(not torch.equal(stored["model"][k], v) for k, v in fresh.items())
    model = SFMNet(cfg, device="cpu", seed=7)
    psnet = {k: v.clone() for k, v in model.depth_estimator.state_dict().items()}
    cli.apply_pretrained(cli.build_parser().parse_args(
        ["--data", root, "--pretrained-flow", str(ckpt)]), model)
    got = model.flow_estimator.state_dict()
    assert set(got) == set(stored["model"])
    assert all(torch.equal(got[k], v) for k, v in stored["model"].items())
    assert all(torch.equal(v, psnet[k]) for k, v in model.depth_estimator.state_dict().items())


def test_cli_train_flow_pwc_refuses_pairs_not_64(tmp_path):
    """A tree rendered at 144x176 (KITTI-like pairs that /8 padding leaves at
    144x176): PWC-DC's size rule is raised before the first step, naming
    the rule; so is a crop that is not /64."""
    root = str(tmp_path / "kitti_flow")
    write_kitti_flow_tree(root, n_pairs=2, hw=(144, 176), seed=2)
    for crop in (("64", "128"), ("72", "128")):
        with pytest.raises(ValueError, match="multiples of 64"):
            cli.main(_argv(root, tmp_path / "out", "--flow-crop", *crop, "--epochs", "1"),
                     device="cpu")
    assert not os.path.exists(tmp_path / "out" / "kitti_flow" / "ckpt")
