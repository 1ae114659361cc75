"""DICL flow pretraining in the port (`train/flow_trainer.py`) against the JAX
package's (`deep_sfm_revisited_tpu/train/flow_trainer.py`).

- The one-cycle schedule against `optax.linear_onecycle_schedule` at every
  step, for step totals where optax's rates are finite; where they are not
  (a total below 20 gives an empty first interval, which optax divides by),
  the port's rates are finite and follow the other intervals.
- Global-norm clipping against `optax.clip_by_global_norm` (below, at and
  above the norm), and not torch's `clip_grad_norm_` rule.
- Three DICL flow steps at 128x128 (search range 1 at every level, so the
  JAX step compiles in ~40 s on the CPU) against JAX `make_flow_train_step`
  with `create_flow_state`'s optimizer (clipping, AdamW with weight decay
  1e-5, the one-cycle schedule), in float64 on both sides (float32
  gradients at random weights flip ReLUs between frameworks; the flows are
  float32 in both, after the costs): the loss and EPE of each step, the
  clipped gradient of the first step (0.1 of it is both optimizers' first
  moment), the parameters after the three steps against optax's AdamW
  applied to the port's own clipped gradients, and every BN statistic.

Tolerances: the schedule to 1e-7 relative (optax rounds its rates to
float32); clipping to 1e-6 relative (float32). The first step: loss and
EPE to 1e-6 relative, its gradient to 1e-5 of the largest gradient element
and 1 - cosine <= 1e-10 (measured 3.2e-6 and 2.6e-12: the float32 flows
after the costs, in both packages, carry ~1e-7 relative noise, which is
most of a gradient as small as level 2's matching net's), the BN statistics
to 1e-6 of each tensor's largest. Adam's first update is about lr sign(g),
so a parameter whose gradient lies within that noise of zero moves up to
2 lr apart in the two frameworks, and the steps after it start from
slightly different weights: the second step's loss and EPE agree to 1e-6
(measured 1.4e-7), the third's to 2e-3 (measured 7e-4), and the BN
statistics after three steps to 2e-3 of each tensor's largest (measured
5.9e-4, in the context nets, downstream of the flows). The parameters
against optax on the port's own gradients to 1e-10 (float64; optax rounds
its rate to float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import load_strict, random_variables

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models import dicl as jdicl
from deep_sfm_revisited_tpu.train import flow_trainer as jft
from deep_sfm_revisited_tpu.train.trainer import TrainState
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models import dicl as tdicl
from deep_sfm_revisited_tpu_torch.train import flow_trainer as tft
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)
B, H, W = 1, 128, 128
LR, TOTAL, STEPS = 4e-4, 40, 3


@pytest.mark.parametrize("total", [20, 37, 100, 1000])
def test_schedule_matches_optax_at_every_step(total):
    want = optax.linear_onecycle_schedule(total, LR, pct_start=0.05)
    got = tft.linear_onecycle_schedule(total, LR, pct_start=0.05)
    for k in range(total + 3):
        np.testing.assert_allclose(got(k), float(want(k)), rtol=1e-7, err_msg=f"step {k}")
    assert got(int(0.05 * total)) == pytest.approx(LR)


@pytest.mark.parametrize("total", [3, 6, 19])
def test_schedule_skips_optax_empty_interval(total):
    """optax's rates are NaN at every step when int(0.05 T) = 0; the port's
    start at the peak and follow optax's later intervals."""
    want = optax.linear_onecycle_schedule(total, LR, pct_start=0.05)
    got = tft.linear_onecycle_schedule(total, LR, pct_start=0.05)
    assert all(np.isnan(float(want(k))) for k in range(total + 1))
    assert got(0) == pytest.approx(LR)
    fin = int(0.85 * total)
    assert got(fin) == pytest.approx(LR / 25)
    assert got(total) == pytest.approx(LR / 25 / 1e4)
    rates = [got(k) for k in range(total + 1)]
    assert all(np.isfinite(rates)) and rates == sorted(rates, reverse=True)


@pytest.mark.parametrize("scale", [0.1, 1.0, 3.0])
def test_clipping_matches_optax(scale):
    rng = np.random.default_rng(0)
    raw = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in raw))
    grads = [g * np.float32(scale / norm) for g in raw]
    if scale == 1.0:
        grads = [g * np.float32(1 + 1e-6) for g in grads]   # just above: clipped
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    n = tft.clip_by_global_norm_(params, 1.0)
    np.testing.assert_allclose(float(n), np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                                     for g in grads)), rtol=1e-6)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
    if scale < 1:
        for p, g in zip(params, grads):
            assert np.array_equal(p.grad.numpy(), g)


SEARCH = {"dicl_search_range": (1, 1, 1, 1, 1)}


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
    jcfg = JConfig.kitti().override(**{f"flow.{k}": v for k, v in SEARCH.items()}).flow
    jnet = jdicl.DICLFlow(jcfg, dtype=jnp.float64)
    pair = jnp.zeros((B, H, W, 6), jnp.float64)
    variables = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.float64),
        random_variables(jnet.init, jax.random.PRNGKey(0), pair, seed=1))
    sched = optax.linear_onecycle_schedule(TOTAL, LR, pct_start=0.05)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-5))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
                       tx=tx)
    step = jft.make_flow_train_step(jnet, jcfg)
    entries = weights.dicl_entries("", "")
    cfg = TConfig.kitti().override(**{"train.lr": LR, "train.mixed_prec": False},
                                   **{f"flow.{k}": v for k, v in SEARCH.items()})
    net = load_strict(tdicl.DICLFlow(cfg.flow), weights.convert(variables, entries)).double()
    trainer = tft.FlowTrainer(net, cfg, total_steps=TOTAL)
    params = dict(net.named_parameters())
    before = {k: v.clone() for k, v in net.state_dict().items()}
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
                                     "batch_stats": state.batch_stats}, entries)
            stats0 = {k: v.clone() for k, v in net.state_dict().items()}
    # optax's AdamW on the port's clipped gradients, from the same start
    adamw = optax.adamw(sched, weight_decay=1e-5)

    @jax.jit
    def update(g, opt, p):
        upd, opt = adamw.update(g, opt, p)
        return optax.apply_updates(p, upd), opt

    p = {k: jnp.asarray(before[k].numpy()) for k in params}
    opt = adamw.init(p)
    for g in grads:
        p, opt = update({k: jnp.asarray(v.numpy()) for k, v in g.items()}, opt, p)
    return dict(jm=jm, tm=tm, trainer=trainer, before=before, jgrad=jgrad, grads=grads,
                stats0=stats0,
                want=p, jstats=weights.convert({"params": state.params,
                                                "batch_stats": state.batch_stats}, entries))


def test_flow_steps_loss_and_epe_match_jax(steps):
    assert steps["trainer"].step == STEPS
    for i, (t, j) in enumerate(zip(steps["tm"], steps["jm"])):
        assert set(t) == set(j) == {"loss", "epe"}
        for k in j:
            assert np.isfinite(t[k]) and t[k] > 0
            np.testing.assert_allclose(t[k], j[k], rtol=1e-6 if i < 2 else 2e-3,
                                       err_msg=f"step {i} {k}")


def test_flow_step_gradient_matches_jax(steps):
    """The first step's clipped gradient of every parameter (0.1 of it is
    the first moment of both AdamWs) against JAX's."""
    got, want = steps["grads"][0], steps["jgrad"]
    assert len(got) > 200
    largest = max(float(want[k].abs().max()) for k in got)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].double().numpy(), rtol=0,
                                   atol=1e-5 * largest, err_msg=k)
    a = torch.cat([g.flatten() for g in got.values()])
    b = torch.cat([want[k].double().flatten() for k in got])
    assert float(1 - a @ b / (a.norm() * b.norm())) <= 1e-10


def test_flow_steps_parameters_are_optax_adamw(steps):
    """Every parameter after the three steps is optax's AdamW (the one-cycle
    rate, weight decay 1e-5 on every parameter) of the port's clipped
    gradients, and every one moved."""
    net, before, want = steps["trainer"].model, steps["before"], steps["want"]
    for k, p in net.named_parameters():
        assert not torch.equal(p.detach(), before[k]), k
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=0, atol=1e-10,
                                   err_msg=k)


@pytest.mark.parametrize("after", [1, STEPS])
def test_flow_steps_batch_statistics_match_jax(steps, after):
    """Every BN running mean and variance after the first step and after the
    third (flax's rule, in both), each moved off its value."""
    before = steps["before"]
    if after == 1:
        got, want, tol = steps["stats0"], steps["jgrad"], 1e-6
    else:
        got, want, tol = steps["trainer"].model.state_dict(), steps["jstats"], 2e-3
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 100
    for k in keys:
        assert not torch.equal(got[k], before[k]), k
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(got[k].numpy(), want[k].double().numpy(), rtol=0,
                                   atol=tol * scale, err_msg=k)
