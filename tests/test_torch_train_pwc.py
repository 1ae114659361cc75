"""The frozen-flow depth-training step on the PWC-DC route, on the CPU.

JAX trains the depth net with PWC-DC frozen through `flow_net(pair,
train=True, all_iters=True)` and `flow_all[-1]` (JAX `models/sfmnet.py:
165-168`). The port's `PWCDCNet.forward(pair, all_iters=True)` returns the
same (5, B, H, W, 2) stack, and runs in train mode where no gradient
reaches it (it has no BN and no dropout). Held here: the stack against
JAX's `PWCDCNet(train=True, all_iters=True)` on one set of weights; one
`Trainer.train_step` on that route against JAX's `_build_loss_fn`, with
PWC-DC's parameters unchanged; and one `cli.main` training epoch on a
golden tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables, t2n

from deep_sfm_revisited_tpu.config import FlowConfig as JFlow
from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models.pwcnet import PWCDCNet as JPWC
from deep_sfm_revisited_tpu.models.sfmnet import SFMNet as JSFMNet
from deep_sfm_revisited_tpu.train.trainer import _build_loss_fn
from deep_sfm_revisited_tpu_torch import cli
from deep_sfm_revisited_tpu_torch.config import FlowConfig as TFlow
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_raw_tree
from deep_sfm_revisited_tpu_torch.models.pwcnet import PWCDCNet as TPWC
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet as TSFMNet
from deep_sfm_revisited_tpu_torch.train.trainer import Trainer
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(2)
B, H, W = 1, 128, 128
OVER = {"flow.estimator": "PWC", "depth.nlabel": 8, "pose.num_hypotheses": 16,
        "pose.ransac_iter": 1, "pose.num_correspondences": 128, "pose.score_subset": 32,
        "pose.score_topk": 64, "pose.polish_iters": 5, "pose.solve_dtype": "float64"}


def _pair(seed, h=H, w=W):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (B, h, w, 3))
    tgt = np.roll(ref, (1, 3), axis=(1, 2)) + 0.05 * rng.randn(B, h, w, 3)
    return ref, tgt, rng


@pytest.fixture(scope="module")
def stack():
    """JAX's and the port's all_iters stacks of one PWC-DC at 64x128, and
    the port's eval flow of the same pair."""
    ref, tgt, _ = _pair(0, 64, 128)
    pair = np.concatenate([ref, tgt], -1).astype(np.float32)
    jnet = JPWC(JFlow(estimator="PWC"))
    variables = random_variables(lambda p: jnet.init(jax.random.PRNGKey(0), p),
                                 jnp.asarray(pair), seed=1)
    jstack, jconf = jax.jit(lambda v, p: jnet.apply(v, p, train=True, all_iters=True))(
        variables, jnp.asarray(pair))
    net = load_strict(TPWC(TFlow(estimator="PWC")),
                      weights.convert(variables, weights.pwc_entries(t="", f="")))
    with torch.no_grad():
        tstack, tconf = net.train()(torch.from_numpy(pair), all_iters=True)
        tflow, _ = net.eval()(torch.from_numpy(pair))
    return dict(j=np.asarray(jstack), jconf=jconf, t=t2n(tstack), tconf=tconf,
                tflow=t2n(tflow), net=net, pair=pair)


# 1e-3 px after the x20, as tests/test_torch_pwcnet.py::test_flow_matches_jax
# (float32 convolutions, sums in other orders; measured: 9.3e-6)
def test_all_iters_stack_matches_jax(stack):
    assert stack["t"].shape == stack["j"].shape == (5, 1, 64, 128, 2)
    assert stack["t"].dtype == np.float32 and stack["tconf"] is None and stack["jconf"] is None
    assert all(np.abs(stack["j"][k]).max() > 1e-2 for k in range(5))   # not vacuous
    np.testing.assert_allclose(stack["t"], stack["j"], rtol=0, atol=1e-3)


def test_stack_ends_with_the_refined_flow(stack):
    """The last entry is the refined level-2 flow, times div_flow then
    resized (JAX's order); the eval flow resizes first: the same flow to
    float32 rounding, not the same bits."""
    np.testing.assert_allclose(stack["t"][-1], stack["tflow"], rtol=0, atol=1e-4)


def test_training_with_gradient_still_raises(stack):
    """A gradient reaches PWC-DC in train mode, with and without all_iters:
    the outputs are those computed without one, and every parameter gets a
    gradient (with all_iters the dilated context net through the last
    entry only). What still raises is an input that is not /64."""
    net = stack["net"].train()
    try:
        for kw, want in (({}, stack["tflow"]), ({"all_iters": True}, stack["t"])):
            net.zero_grad(set_to_none=True)
            out, _ = net(torch.from_numpy(stack["pair"]), **kw)
            np.testing.assert_allclose(t2n(out), want, rtol=0, atol=1e-5)
            out.abs().mean().backward()
            for k, p in net.named_parameters():
                assert p.grad is not None and p.grad.abs().max() > 0, (kw, k)
        with pytest.raises(ValueError, match="multiples of 64"):
            net(torch.from_numpy(stack["pair"][:, :, :96]))
    finally:
        net.zero_grad(set_to_none=True)
        net.eval()


def _draws(key, cfg):
    """The JAX composite's draws for `key`: PWC-DC gives no confidence, so
    the uniform sampler's candidate grid (one candidate a point)."""
    pc = cfg.pose
    k_sample, k_ransac = jax.random.split(key)
    k_grid, _ = jax.random.split(k_sample)
    return {"jitter": torch.from_numpy(np.array(jax.random.uniform(
                k_grid, (B, pc.num_correspondences, 2), jnp.float32, -0.5, 0.5))),
            "sample_idx": torch.from_numpy(np.array(jax.random.randint(
                k_ransac, (B, pc.num_hypotheses * pc.ransac_iter, 5), 0,
                pc.num_correspondences)))}


@pytest.fixture(scope="module")
def step():
    """One frozen-PWC-DC step of the port and JAX's objective on the same
    weights, batch and draws, in float32 (the recipe's type)."""
    ref, tgt, rng = _pair(0)
    a = 0.03
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    gt = rng.uniform(1.5, 7.5, (B, H, W))
    gt[rng.rand(B, H, W) < 0.7] = 0.0
    batch = {"ref": ref, "target": tgt,
             "intrinsics": np.array([[[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]]]),
             "pose_gt": np.concatenate([R, [[0.2], [0.0], [0.7]]], 1)[None], "depth_gt": gt}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    cfg_j, cfg_t = JConfig.kitti().override(**OVER), TConfig.kitti().override(**OVER)
    jnet = JSFMNet(cfg_j)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = random_variables(lambda r, t, k: jnet.init(jax.random.PRNGKey(1), r, t, k,
                                                           key=jax.random.PRNGKey(2)),
                                 jb["ref"], jb["target"], jb["intrinsics"], seed=3)
    key = jax.random.PRNGKey(5)
    jloss, (jaux, _) = jax.jit(_build_loss_fn(jnet, cfg_j))(
        variables["params"], variables["batch_stats"], jb, key)

    model = TSFMNet(cfg_t, device="cpu")
    load_strict(model, weights.jax_params_to_torch(variables, flow_estimator="PWC"))
    trainer = Trainer(model, cfg_t, steps_per_epoch=10)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    metrics = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                 noise=False, draws=_draws(key, cfg_t))
    return dict(jloss=float(jloss), jaux={k: float(v) for k, v in jaux.items()},
                metrics={k: float(v) for k, v in metrics.items()}, model=model,
                before=before, trainer=trainer)


def test_step_loss_matches_jax(step):
    """The loss and every metric of JAX's objective (depth terms, valid
    share; PWC-DC gives no confidence, so no match count) to 1e-5, as
    tests/test_torch_train_step.py holds DICL's route (measured: 6e-8)."""
    m, jaux = step["metrics"], step["jaux"]
    assert np.isfinite(m["loss"]) and m["loss"] > 0
    np.testing.assert_allclose(m["loss"], step["jloss"], rtol=1e-5)
    assert set(m) == set(jaux) | {"loss"}
    for k, v in jaux.items():
        np.testing.assert_allclose(m[k], v, rtol=1e-5, atol=1e-9, err_msg=k)


def test_step_leaves_pwc_frozen(step):
    """PWC-DC's parameters are bit-identical after the step and got no
    gradient; PSNet's moved."""
    model, before = step["model"], step["before"]
    assert step["trainer"].step == 1
    for k, p in model.flow_estimator.named_parameters():
        assert torch.equal(p.detach(), before[f"flow_estimator.{k}"]), k
        assert p.grad is None, k
    assert any(not torch.equal(p.detach(), before[f"depth_estimator.{k}"])
               for k, p in model.depth_estimator.named_parameters())


TINY = {"flow.estimator": "PWC", "data.pad_multiple": 64, "depth.nlabel": 8,
        "pose.num_hypotheses": 16, "pose.ransac_iter": 1, "pose.num_correspondences": 128,
        "pose.polish_iters": 2, "data.train_size": (64, 128)}


def test_cli_trains_an_epoch_on_the_pwc_route(tmp_path):
    """`cli.main` training (no `-v`) with `flow.estimator=PWC` on a golden
    tree: one epoch of 2 steps at batch 1 completes with a finite loss and
    finite Eigen metrics, and the checkpoint's PWC-DC weights are the
    seeded initial ones, bit for bit."""
    root = tmp_path / "golden_raw"
    write_kitti_raw_tree(str(root), n_frames=4, hw=(64, 128), n_test=2)
    out = tmp_path / "out"
    recs = cli.main(["--data", str(root), "--cfg", "kitti", "--gt-depth-dir",
                     f"{root}/gt_depth", "--out", str(out), "--workers", "2", "-b", "1",
                     "--epochs", "1", "--override", *[f"{k}={v}" for k, v in TINY.items()]],
                    device="cpu")
    assert len(recs) == 1 and recs[0]["step"] == 2
    assert np.isfinite(recs[0]["train_loss"]) and recs[0]["train_loss"] > 0
    assert all(np.isfinite(recs[0][k]) for k in ("abs_rel", "rmse", "a1"))
    cfg = TConfig.kitti().override(**TINY)
    fresh = TSFMNet(cfg, device="cpu", seed=cfg.train.seed).state_dict()
    stored = torch.load(out / "kitti" / "ckpt" / "0.pt", weights_only=True)["model"]
    flow_keys = [k for k in fresh if k.startswith("flow_estimator.")]
    assert len(flow_keys) == 126
    for k in flow_keys:
        assert torch.equal(stored[k], fresh[k]), k
    assert any(not torch.equal(stored[k], fresh[k]) for k in fresh
               if k.startswith("depth_estimator.") and fresh[k].is_floating_point())
