"""RAFT flow pretraining in the port (`train/flow_trainer.py`, `cli.main
--train-flow --override flow.estimator=RAFT`) against the JAX package's, and
the frozen RAFT in the composite's training.

- Two RAFT flow steps at 64x96, b = 2, 2 iterations, against JAX
  `make_flow_train_step` with `create_flow_state`'s optimizer (clipping,
  AdamW with weight decay 1e-5, the one-cycle schedule), in float64 on both
  sides: RAFT's sequence loss (gamma 0.8) over the `all_iters` stack and
  the EPE of the last. The correlation pyramid is bfloat16 in both and the
  lookup float32 on float32 coordinates (JAX `models/raft.py:116, 156-176`),
  so the float64 steps carry float32 noise there, and a value near a
  bfloat16 rounding boundary can round the other way. Held: the loss and
  EPE of both steps; the first step's clipped gradient of every parameter;
  the parameters after the two steps against optax's AdamW applied to the
  port's own clipped gradients; cnet's BatchNorm statistics after the steps.
- `cli.main --train-flow` with RAFT on a rendered KITTI flow tree: an epoch
  of two steps, the validation's EPE and Fl-all, a checkpoint that
  `--pretrained-flow` restores into an SFMNet built with
  `flow.estimator=RAFT`; a crop that is not /8 refused before the first
  step.
- One `cli.main` depth-training epoch with RAFT frozen (the recipe's
  `train.fix_flownet`): RAFT's parameters in the checkpoint are the seeded
  ones, bit for bit (its BatchNorm statistics move, by flax's rule, as in
  JAX's train-mode forward).

Tolerances (measured on the CPU in brackets): the first step's loss and
EPE to 1e-5 relative (2e-7, 3e-7: float32 noise in the lookup's
coordinates and sums); its gradient to 1e-4 of the largest gradient
element (2.3e-5) and 1 - cosine <= 1e-8 (1.6e-9); the second step's loss
and EPE to 1e-4 (1.6e-5, 1.5e-5: Adam's first update is about lr sign(g),
so a gradient element within the noise of zero moves its parameter up to
2 lr apart);
the parameters against optax on the port's own gradients to 1e-10
(float64; optax rounds its rate to float32).
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import load_strict, random_variables

from deep_sfm_revisited_tpu.config import FlowConfig as JFlow
from deep_sfm_revisited_tpu.models.raft import RAFT as JRAFT
from deep_sfm_revisited_tpu.train import flow_trainer as jft
from deep_sfm_revisited_tpu.train.trainer import TrainState
from deep_sfm_revisited_tpu_torch import cli
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.data.synthetic import (write_kitti_flow_tree,
                                                         write_kitti_raw_tree)
from deep_sfm_revisited_tpu_torch.models.raft import RAFT as TRAFT
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
from deep_sfm_revisited_tpu_torch.train import flow_trainer as tft
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(2)
B, H, W = 2, 64, 96
LR, TOTAL, STEPS = 4e-4, 40, 2
RAFT2 = {"flow.estimator": "RAFT", "flow.raft_iters_train": 2, "flow.raft_iters_eval": 2}


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
    jcfg = dataclasses.replace(JFlow(), raft_iters_train=2)
    jnet = JRAFT(jcfg, dtype=jnp.float64)
    pair = jnp.zeros((B, H, W, 6), jnp.float64)
    variables = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.float64),
        random_variables(jnet.init, jax.random.PRNGKey(0), pair, seed=1))
    sched = optax.linear_onecycle_schedule(TOTAL, LR, pct_start=0.05)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-5))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), tx=tx)
    step = jft.make_flow_train_step(jnet, jcfg)
    entries = weights.raft_entries(t="", f="")
    cfg = TConfig.kitti().override(**RAFT2, **{"train.lr": LR, "train.mixed_prec": False})
    net = load_strict(TRAFT(cfg.flow), weights.convert(variables, entries)).double()
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
            jgrad = weights.convert({"params": jax.tree_util.tree_map(lambda v: v / 0.1, mu),
                                     "batch_stats": variables["batch_stats"]}, entries)
    adamw = optax.adamw(sched, weight_decay=1e-5)

    @jax.jit
    def update(g, opt, p):
        upd, opt = adamw.update(g, opt, p)
        return optax.apply_updates(p, upd), opt

    p = {k: jnp.asarray(before[k].numpy()) for k in params}
    opt = adamw.init(p)
    for g in grads:
        p, opt = update({k: jnp.asarray(v.numpy()) for k, v in g.items()}, opt, p)
    stats = weights.convert({"params": state.params, "batch_stats": state.batch_stats}, entries)
    return dict(jm=jm, tm=tm, trainer=trainer, before=before, jgrad=jgrad, grads=grads,
                want=p, stats=stats)


def test_raft_flow_steps_loss_and_epe_match_jax(steps):
    assert steps["trainer"].step == STEPS
    for i, (t, j) in enumerate(zip(steps["tm"], steps["jm"])):
        assert set(t) == set(j) == {"loss", "epe"}
        for k in j:
            assert np.isfinite(t[k]) and t[k] > 0
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5 if i == 0 else 1e-4,
                                       err_msg=f"step {i} {k}")


def test_raft_flow_step_gradient_matches_jax(steps):
    """The first step's clipped gradient of every parameter against JAX's
    (the instance norms' scale and bias included); every one is non-zero."""
    got, want = steps["grads"][0], steps["jgrad"]
    assert set(got) == {k for k in want if "running" not in k and "num_batches" not in k}
    largest = max(float(want[k].abs().max()) for k in got)
    for k, g in got.items():
        assert g.abs().max() > 0, k
        np.testing.assert_allclose(g.numpy(), want[k].double().numpy(), rtol=0,
                                   atol=1e-4 * largest, err_msg=k)
    a = torch.cat([g.flatten() for g in got.values()])
    b = torch.cat([want[k].double().flatten() for k in got])
    assert float(1 - a @ b / (a.norm() * b.norm())) <= 1e-8


def test_raft_flow_steps_parameters_are_optax_adamw(steps):
    """Every parameter after the two steps is optax's AdamW of the port's
    clipped gradients, and every one moved; cnet's BatchNorm statistics are
    JAX's after its two train-mode forwards."""
    net, before, want = steps["trainer"].model, steps["before"], steps["want"]
    for k, p in net.named_parameters():
        assert not torch.equal(p.detach(), before[k]), k
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-10, err_msg=k)
    for k, v in net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), steps["stats"][k].double().numpy(), rtol=1e-6,
                                       atol=1e-8, err_msg=k)


TINY = {**RAFT2, "train.mixed_prec": False}


def _argv(root, out, *extra):
    return ["--data", root, "--cfg", "kitti", "--train-flow", "--flow-dataset", "kitti",
            "--out", str(out), "--workers", "2", "-b", "2", *extra,
            "--override", *[f"{k}={v}" for k, v in TINY.items()]]


def test_cli_train_flow_raft_epoch_and_pretrained_flow(tmp_path):
    """One epoch of two steps at b = 2 on 64x96 crops of a 4-pair tree
    rendered at 96x136 (validation pairs padded to 96x136); finite loss and
    training EPE, the validation's EPE and Fl-all over the four pairs;
    RAFT's parameters moved from the seeded ones; `--pretrained-flow`
    restores every RAFT tensor into an SFMNet with `flow.estimator=RAFT` and
    leaves PSNet untouched."""
    root = str(tmp_path / "kitti_flow")
    write_kitti_flow_tree(root, n_pairs=4, hw=(96, 136), seed=1)
    out = tmp_path / "out"
    history = cli.main(_argv(root, out, "--flow-crop", "64", "96", "--epochs", "1"),
                       device="cpu")
    assert len(history) == 1 and history[0]["step"] == 2 and history[0]["n"] == 4
    for k in ("train_loss", "train_epe", "epe", "f1_all"):
        assert math.isfinite(history[0][k]) and history[0][k] >= 0, k
    ckpt = out / "kitti_flow" / "ckpt"
    stored = torch.load(ckpt / "0.pt", weights_only=True)
    assert stored["config"]["flow"]["estimator"] == "RAFT"
    cfg = TConfig.kitti().override(**TINY)
    fresh = tft.build_flow_model(cfg.flow, seed=cfg.train.seed)
    assert set(stored["model"]) == set(fresh.state_dict())
    assert all(not torch.equal(stored["model"][k], p) for k, p in fresh.named_parameters())
    model = SFMNet(cfg, device="cpu", seed=7)
    psnet = {k: v.clone() for k, v in model.depth_estimator.state_dict().items()}
    cli.apply_pretrained(cli.build_parser().parse_args(
        ["--data", root, "--pretrained-flow", str(ckpt)]), model)
    got = model.flow_estimator.state_dict()
    assert set(got) == set(stored["model"])
    assert all(torch.equal(got[k], v) for k, v in stored["model"].items())
    assert all(torch.equal(v, psnet[k]) for k, v in model.depth_estimator.state_dict().items())


def test_cli_train_flow_raft_refuses_a_crop_not_8(tmp_path):
    """A crop whose sides are not multiples of 8 (the /8 padding would part
    the prediction from the unpadded flow GT): RAFT's size rule is raised
    before the first step, naming the rule."""
    root = str(tmp_path / "kitti_flow")
    write_kitti_flow_tree(root, n_pairs=2, hw=(96, 136), seed=2)
    with pytest.raises(ValueError, match="multiples of 8"):
        cli.main(_argv(root, tmp_path / "out", "--flow-crop", "60", "96", "--epochs", "1"),
                 device="cpu")
    assert not os.path.exists(tmp_path / "out" / "kitti_flow" / "ckpt")


DEPTH = {**RAFT2, "data.pad_multiple": 64, "depth.nlabel": 8, "pose.num_hypotheses": 16,
         "pose.ransac_iter": 1, "pose.num_correspondences": 128, "pose.polish_iters": 2,
         "data.train_size": (64, 128)}


def test_cli_trains_an_epoch_with_raft_frozen(tmp_path):
    """`cli.main` training (no `-v`) with `flow.estimator=RAFT` on a golden
    tree: one epoch of 2 steps at batch 1 completes with a finite loss and
    finite Eigen metrics; RAFT's parameters in the checkpoint are the
    seeded ones, bit for bit, and PSNet's moved."""
    root = tmp_path / "golden_raw"
    write_kitti_raw_tree(str(root), n_frames=4, hw=(64, 128), n_test=2)
    out = tmp_path / "out"
    recs = cli.main(["--data", str(root), "--cfg", "kitti", "--gt-depth-dir",
                     f"{root}/gt_depth", "--out", str(out), "--workers", "2", "-b", "1",
                     "--epochs", "1", "--override", *[f"{k}={v}" for k, v in DEPTH.items()]],
                    device="cpu")
    assert len(recs) == 1 and recs[0]["step"] == 2
    assert np.isfinite(recs[0]["train_loss"]) and recs[0]["train_loss"] > 0
    assert all(np.isfinite(recs[0][k]) for k in ("abs_rel", "rmse", "a1"))
    cfg = TConfig.kitti().override(**DEPTH)
    model = SFMNet(cfg, device="cpu", seed=cfg.train.seed)
    fresh = model.state_dict()
    stored = torch.load(out / "kitti" / "ckpt" / "0.pt", weights_only=True)["model"]
    flow_params = [f"flow_estimator.{k}" for k, _ in model.flow_estimator.named_parameters()]
    assert len(flow_params) > 100
    for k in flow_params:
        assert torch.equal(stored[k], fresh[k]), k
    assert any(not torch.equal(stored[k], fresh[k]) for k in fresh
               if k.startswith("depth_estimator.") and fresh[k].is_floating_point())
