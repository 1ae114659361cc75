"""The port's `cli -v` end to end on a golden KITTI raw tree, on the CPU,
against the JAX package's eval step."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import random_variables

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.data import BatchLoader, Compose, KittiRawDataset, Normalize
from deep_sfm_revisited_tpu.models.sfmnet import SFMNet as JSFMNet
from deep_sfm_revisited_tpu.train.trainer import (TrainState, _build_eval_metrics_fn,
                                                  make_eval_step)
from deep_sfm_revisited_tpu_torch import cli
from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_raw_tree
from deep_sfm_revisited_tpu_torch.utils.weights import jax_params_to_torch

torch.set_num_threads(2)
TINY = {"depth.nlabel": 8, "pose.num_hypotheses": 16, "pose.ransac_iter": 1,
        "pose.num_correspondences": 128, "pose.polish_iters": 2}
PAD = {"PWC": 64, "DICL": 128}          # PWC-DC needs /64, DICL /128


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("golden_raw"))
    write_kitti_raw_tree(root, n_frames=5, hw=(64, 96), n_test=3)
    return root


def _argv(tree, out, over, *extra):
    return ["--data", tree, "--cfg", "kitti", "-v", "--gt-depth-dir", f"{tree}/gt_depth",
            "--out", str(out), "--workers", "2", *extra,
            "--override", *[f"{k}={v}" for k, v in over.items()]]


def _jax_metric_keys(over, hw):
    """The JAX eval step's metric names on this route, by an abstract trace
    (no compile)."""
    cfg = JConfig.kitti().override(**over)
    net = JSFMNet(cfg)
    x = jax.ShapeDtypeStruct((1, *hw, 3), jnp.float32)
    K = jax.ShapeDtypeStruct((1, 3, 3), jnp.float32)
    v = jax.eval_shape(lambda r, t, k: net.init(jax.random.PRNGKey(0), r, t, k,
                                                key=jax.random.PRNGKey(1)), x, x, K)
    batch = {"ref": x, "target": x, "intrinsics": K,
             "pose_gt": jax.ShapeDtypeStruct((1, 3, 4), jnp.float32),
             "depth_gt": jax.ShapeDtypeStruct((1, *hw), jnp.float32),
             "raw_hw": jax.ShapeDtypeStruct((1, 2), jnp.int32)}
    fn = _build_eval_metrics_fn(net, cfg)
    out = jax.eval_shape(lambda vv, b: fn(TrainState(0, vv["params"], vv["batch_stats"], (),
                                                     None), b, jax.random.PRNGKey(2))[0],
                         v, batch)
    return set(out)


@pytest.mark.parametrize("flow", ["PWC", "DICL"])
def test_cli_validate_end_to_end(tree, tmp_path, flow):
    """Random weights, online RANSAC: finite metrics under the JAX eval
    step's names (PWC-DC reports no confident-candidate counts), the run's
    config and metric logs on disk."""
    over = dict(TINY, **{"flow.estimator": flow, "data.pad_multiple": PAD[flow]})
    res = cli.main(_argv(tree, tmp_path, over), device="cpu")
    assert set(res) == _jax_metric_keys(over, (PAD[flow], 128))
    assert len(res) == (9 if flow == "PWC" else 11)
    assert all(np.isfinite(v) for v in res.values())
    run = tmp_path / "kitti"
    assert (run / "config.yaml").exists() and (run / "test" / "scalars.jsonl").exists()


def test_cli_metrics_equal_the_jax_eval_step(tree, tmp_path):
    """Under `use_gt_pose`, with the same weights through the bridge and
    `--pretrained-torch`: the port's mean metrics equal the mean of the JAX
    eval step's over the same batches to 1e-4 (float32 PSNet, as
    tests/test_torch_psnet.py)."""
    over = dict(TINY, **{"flow.estimator": "PWC", "data.pad_multiple": 64,
                         "use_gt_pose": True, "train.mixed_prec": False})
    cfg = JConfig.kitti().override(**over)
    net = JSFMNet(cfg)
    x = jnp.zeros((1, 64, 128, 3), jnp.float32)
    K = jnp.asarray([[[70.0, 0, 48], [0, 70.0, 32], [0, 0, 1]]], jnp.float32)
    variables = random_variables(lambda r, t, k: net.init(
        jax.random.PRNGKey(0), r, t, k, key=jax.random.PRNGKey(1)), x, x, K, seed=4)
    step = make_eval_step(net, cfg)
    state = TrainState(0, variables["params"], variables["batch_stats"], (), None)
    ds = KittiRawDataset(tree, train=False, gt_depth_dir=f"{tree}/gt_depth",
                         transform=Compose([Normalize()]))
    sums = {}
    batches = list(BatchLoader(ds, 1, shuffle=False, workers=1, pad_multiple=64,
                               drop_last=False))
    for b in batches:
        m, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
    ckpt = str(tmp_path / "pwc.pth.tar")
    torch.save({"epoch": 0, "state_dict": jax_params_to_torch(variables,
                                                              flow_estimator="PWC")}, ckpt)
    res = cli.main(_argv(tree, tmp_path, over, "--pretrained-torch", ckpt), device="cpu")
    assert set(res) == set(sums)
    for k in sums:
        np.testing.assert_allclose(res[k], sums[k] / len(batches), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("extra", [["--train-flow"]])
def test_unported_modes_raise(tree, tmp_path, extra):
    """Flow pretraining is ported for DICL and PWC-DC
    (tests/test_torch_train_pwc_flow.py runs PWC-DC's); at KITTI's default
    crop, 288x960, which /8 padding keeps and whose 288 rows are not a
    multiple of 64, PWC-DC's size rule refuses it before the first step
    (JAX's first step fails there on its warp's shapes)."""
    with pytest.raises(ValueError, match="multiples of 64"):
        cli.main(_argv(tree, tmp_path, dict(TINY, **{"flow.estimator": "PWC"}), *extra),
                 device="cpu")


def test_training_raises(tree, tmp_path):
    """Training the flow net (`train.fix_flownet=False`) is ported for DICL
    and PWC-DC (tests/test_torch_train_cli.py trains an epoch on the PWC-DC
    route); what raises on that route is a training crop that is not /64
    after the loader's padding, 64x96 padded to /32: PWC-DC's size rule, a
    ValueError at the first step."""
    over = dict(TINY, **{"train.fix_flownet": False, "flow.estimator": "PWC",
                         "data.pad_multiple": 32, "data.train_size": (64, 96)})
    argv = [a for a in _argv(tree, tmp_path, over) if a != "-v"]
    with pytest.raises(ValueError, match="multiples of 64"):
        cli.main(argv, device="cpu")


def test_entry_point_without_cuda_raises(tree, tmp_path):
    """`cli.main` runs on the GPU unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_argv(tree, tmp_path, TINY))
    assert not os.path.exists(tmp_path / "kitti" / "test")


def test_cli_validate_end_to_end_on_the_raft_route(tree, tmp_path):
    """`cli -v` with `flow.estimator=RAFT` (2 eval iterations), random
    weights, online RANSAC on the uniform grid (RAFT gives no confidence):
    finite metrics under the JAX eval step's names, and the run's config and
    metric logs on disk."""
    over = dict(TINY, **{"flow.estimator": "RAFT", "flow.raft_iters_eval": 2,
                         "data.pad_multiple": 32})
    res = cli.main(_argv(tree, tmp_path, over), device="cpu")
    assert set(res) == _jax_metric_keys(over, (64, 96))
    assert len(res) == 9
    assert all(np.isfinite(v) for v in res.values())
    run = tmp_path / "kitti"
    assert (run / "config.yaml").exists() and (run / "test" / "scalars.jsonl").exists()
