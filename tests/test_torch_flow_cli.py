"""`cli.main --train-flow` end to end on the CPU: DICL flow pretraining over a
tiny KITTI 2015 flow tree (`data/synthetic.py::write_kitti_flow_tree`,
rendered views of the analytic scene with their exact flow and a sparse
valid mask), cropped to 128x128, two epochs of two steps; its per-epoch
checkpoints under `{out}/{tag}_flow/ckpt` with the best epoch by
validation EPE copied to `model_best.pt`; then `--pretrained-flow` restores
the flow checkpoint into the SfM composite with every DICL tensor equal and
PSNet untouched (as the JAX package's tests/test_flow_pretrain_cli.py
does). Also the JAX package's refusal of an unpadded flow crop, kept: a
crop whose sides are not multiples of 128 raises.
"""

import json
import math
import os

import pytest
import torch

from deep_sfm_revisited_tpu_torch import cli
from deep_sfm_revisited_tpu_torch.config import SfMConfig
from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_flow_tree
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet

torch.set_num_threads(2)
TINY = {"depth.nlabel": 8, "pose.num_hypotheses": 16, "pose.ransac_iter": 1,
        "pose.num_correspondences": 128, "pose.polish_iters": 2, "train.mixed_prec": False}


def _argv(root, out, *extra):
    return ["--data", root, "--cfg", "kitti", "--train-flow", "--flow-dataset", "kitti",
            "--out", str(out), "--workers", "2", "-b", "2", *extra,
            "--override", *[f"{k}={v}" for k, v in TINY.items()]]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_flow"))
    write_kitti_flow_tree(root, n_pairs=4, hw=(144, 176), seed=1)
    out = tmp_path_factory.mktemp("out")
    history = cli.main(_argv(root, out, "--flow-crop", "128", "128", "--epochs", "2"),
                       device="cpu")
    return history, out, root


def test_train_flow_runs_and_validates(run):
    """Two epochs of two steps at b = 2; each epoch's record has a finite
    loss and training EPE and the validation's EPE and Fl-all over the four
    pairs (padded to /128, cropped back)."""
    history, _, _ = run
    assert [r["epoch"] for r in history] == [0, 1]
    assert [r["step"] for r in history] == [2, 4]
    for r in history:
        for k in ("train_loss", "train_epe", "epe", "f1_all"):
            assert math.isfinite(r[k]) and r[k] >= 0, (k, r)
        assert r["n"] == 4


def test_train_flow_checkpoints_and_best_epoch(run):
    history, out, _ = run
    ckpt = out / "kitti_flow" / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["0.pt", "1.pt", "model_best.pt"]
    best = min(range(2), key=lambda e: history[e]["epe"])
    stored = torch.load(ckpt / "model_best.pt", weights_only=True)
    assert stored["epoch"] == best and stored["step"] == 2 * (best + 1)
    assert stored["config"]["flow"]["estimator"] == "DICL"
    first = torch.load(ckpt / "0.pt", weights_only=True)["model"]
    last = torch.load(ckpt / "1.pt", weights_only=True)["model"]
    assert not torch.equal(first["matching2.match.0.conv.weight"],
                           last["matching2.match.0.conv.weight"])
    # the step scalars: one window per epoch (print_freq exceeds its steps)
    lines = (out / "kitti_flow" / "flow_train" / "scalars.jsonl").read_text().splitlines()
    assert [(json.loads(x)["tag"], json.loads(x)["step"]) for x in lines] == [
        ("epe", 2), ("loss", 2), ("epe", 4), ("loss", 4)]


def test_pretrained_flow_restores_into_the_composite(run):
    """The flow checkpoint holds DICL alone; `--pretrained-flow` loads every
    DICL tensor of the newest epoch into SFMNet and leaves PSNet as it was."""
    _, out, root = run
    ckpt = str(out / "kitti_flow" / "ckpt")
    model = SFMNet(SfMConfig.kitti().override(**TINY), device="cpu", seed=7)
    psnet = {k: v.clone() for k, v in model.depth_estimator.state_dict().items()}
    args = cli.build_parser().parse_args(["--data", root, "--pretrained-flow", ckpt])
    cli.apply_pretrained(args, model)
    want = torch.load(os.path.join(ckpt, "1.pt"), weights_only=True)["model"]
    got = model.flow_estimator.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in model.depth_estimator.state_dict().items():
        assert torch.equal(v, psnet[k]), k


def test_unpadded_flow_crop_raises(run, tmp_path):
    """KITTIFlow's default crop (288, 960) is padded to 384x1024 for DICL while
    the flow GT is not: the multiscale loss refuses it, as JAX's does (there
    with a reshape TypeError)."""
    _, _, root = run
    with pytest.raises(ValueError, match="multiples of 128"):
        cli.main(_argv(root, tmp_path, "--flow-crop", "96", "128", "--epochs", "1"),
                 device="cpu")
