"""The port's `cli.main` in training mode end to end, on the CPU.

A golden KITTI raw tree at 64x128 (`data/synthetic.py`), the recipe's
frozen-flow depth step through the train loader (crop to
`data.train_size`, zoom, flip, pair offset and direction draws), one epoch
of 2 steps at batch 1 with image panes at step 2, the validation after it,
a checkpoint, and a second run resumed from it with `--pretrained ...
--start-epoch 1`. Tiny overrides (nlabel 8, 16 hypotheses, 128
correspondences).
"""

import json
import os

import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu_torch import cli
from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_raw_tree

torch.set_num_threads(2)
TINY = {"depth.nlabel": 8, "pose.num_hypotheses": 16, "pose.ransac_iter": 1,
        "pose.num_correspondences": 128, "pose.polish_iters": 2,
        "data.train_size": (64, 128), "train.image_freq": 2}
EIGEN = {"abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3", "l1_inv", "sc_inv"}


def _argv(root, out, *extra, over=TINY):
    return ["--data", root, "--cfg", "kitti", "--gt-depth-dir", f"{root}/gt_depth",
            "--out", str(out), "--workers", "2", "-b", "1", *extra,
            "--override", *[f"{k}={v}" for k, v in over.items()]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(first run's records, resumed run's records, out dir, tree root)."""
    root = str(tmp_path_factory.mktemp("golden_raw"))
    write_kitti_raw_tree(root, n_frames=4, hw=(64, 128), n_test=2)   # 2 train pairs, 2 test
    out = tmp_path_factory.mktemp("out")
    first = cli.main(_argv(root, out, "--epochs", "1"), device="cpu")
    ckpt = os.path.join(out, "kitti", "ckpt")
    resumed = cli.main(_argv(root, out, "--epochs", "2", "--start-epoch", "1",
                             "--pretrained", ckpt), device="cpu")
    return first, resumed, out, root


def test_one_epoch_trains_validates_and_checkpoints(runs):
    first, _, out, _ = runs
    assert len(first) == 1
    rec = first[0]
    assert rec["epoch"] == 0 and rec["step"] == 2
    assert np.isfinite(rec["train_loss"]) and rec["train_loss"] > 0
    assert EIGEN | {"num_matches", "uniform_fallback"} <= set(rec)
    assert all(np.isfinite(rec[k]) for k in EIGEN)
    run = out / "kitti"
    assert (run / "config.yaml").exists() and (run / "ckpt" / "0.pt").exists()
    state = torch.load(run / "ckpt" / "0.pt", weights_only=True)
    assert state["step"] == 2 and state["epoch"] == 0
    assert tuple(state["config"]["data"]["train_size"]) == (64, 128)
    lines = [json.loads(x) for x in (run / "train" / "scalars.jsonl").read_text().splitlines()]
    losses = [x for x in lines if x["tag"] == "loss"]
    assert [x["step"] for x in losses[:2]] == [1, 2]
    assert {"depth_init", "depth_out", "num_matches", "uniform_fallback"} <= {
        x["tag"] for x in lines}
    # every image_freq = 2 steps, in this run and in the resumed one
    panes = {f for f in os.listdir(run / "train") if f.endswith(".png")}
    assert panes == {f"train_{k}_{step}.png" for step in (2, 4)
                     for k in ("depth_gt", "depth_pred", "flow", "input")}


def test_validation_logs_progress_and_writes_test_panes(runs):
    """The epoch's validation (2 pairs) logs `Test: [1/2]` and the final
    means, and writes the `test/*` panes at its image_freq = 2nd pair, in
    each run: files and event-file tags."""
    from deep_sfm_revisited_tpu_torch.utils.tb_events import read_events

    _, _, out, _ = runs
    run = out / "kitti"
    log = "".join(p.read_text() for p in run.glob("kitti_*.log"))
    assert log.count("Test: [1/2]\t abs_rel ") == 2
    test = run / "test"
    panes = {f for f in os.listdir(test) if f.endswith(".png")}
    assert panes == {f"test_{k}_2.png" for k in ("depth_gt", "depth_pred", "flow", "input")}
    events = [e for f in os.listdir(test) if "tfevents" in f
              for e in read_events(str(test / f)) if "tag" in e]
    assert {(e["tag"], e["step"]) for e in events if e["tag"].startswith("test/")} == {
        (f"test/{k}", 2) for k in ("depth_gt", "depth_pred", "flow", "input")}


def test_start_epoch_resumes_from_the_checkpoint(runs):
    """The resumed run trains epoch 1 only, continuing the step count and
    the optimizer from epoch 0's checkpoint, and writes epoch 1's."""
    first, resumed, out, _ = runs
    assert [r["epoch"] for r in resumed] == [1]
    assert resumed[0]["step"] == 4 and np.isfinite(resumed[0]["train_loss"])
    state = torch.load(out / "kitti" / "ckpt" / "1.pt", weights_only=True)
    assert state["step"] == 4
    before = torch.load(out / "kitti" / "ckpt" / "0.pt", weights_only=True)
    flow = [k for k in state["model"] if k.startswith("flow_estimator.") and k.endswith("weight")]
    depth = [k for k in state["model"] if k.startswith("depth_estimator.") and
             k.endswith("weight")]
    assert all(torch.equal(state["model"][k], before["model"][k]) for k in flow)
    assert any(not torch.equal(state["model"][k], before["model"][k]) for k in depth)


def test_validate_restores_the_checkpoint(runs, tmp_path):
    """`-v --pretrained <ckpt>` evaluates the trained weights: finite metrics,
    and the same ones as the training run's validation after epoch 1."""
    _, resumed, out, root = runs
    res = cli.main(["-v", *_argv(root, tmp_path, "--pretrained", str(out / "kitti" / "ckpt"))],
                   device="cpu")
    for k in EIGEN:
        assert np.isfinite(res[k])
        np.testing.assert_allclose(res[k], resumed[0][k], rtol=1e-6, err_msg=k)


def test_training_the_flow_net_raises(runs, tmp_path):
    """`train.fix_flownet=False` trains DICL and PWC-DC
    (tests/test_torch_flow_train_depth.py); on the PWC-DC route `cli.main`
    trains an epoch with PWC-DC in train mode under autograd: 2 steps, a
    finite loss without a flow term (KITTI depth batches carry no flow GT,
    so PWC-DC gets no gradient and its checkpointed weights are the seeded
    ones, as in JAX), finite Eigen metrics. What still raises on the route
    is an input PWC-DC does not take (tests/test_torch_cli.py)."""
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet

    _, _, _, root = runs
    over = dict(TINY, **{"train.fix_flownet": False, "flow.estimator": "PWC",
                         "data.pad_multiple": 64})
    recs = cli.main(_argv(root, tmp_path, "--epochs", "1", over=over), device="cpu")
    assert len(recs) == 1 and recs[0]["step"] == 2
    assert np.isfinite(recs[0]["train_loss"]) and recs[0]["train_loss"] > 0
    assert "flow_loss" not in recs[0] and all(np.isfinite(recs[0][k]) for k in EIGEN)
    cfg = SfMConfig.kitti().override(**over)
    fresh = SFMNet(cfg, device="cpu", seed=cfg.train.seed).state_dict()
    stored = torch.load(tmp_path / "kitti" / "ckpt" / "0.pt", weights_only=True)["model"]
    flow = [k for k in fresh if k.startswith("flow_estimator.")]
    assert len(flow) == 126 and all(torch.equal(stored[k], fresh[k]) for k in flow)
