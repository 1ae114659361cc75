"""The port's pose tools through `cli.main`, on the CPU, against the JAX package's.

`--record-pose --dataset kitti_vo` on a golden VO tree with the POSENET
route and PWC-DC flow (no RANSAC, so the pose is fixed by the weights):
the port's errors and per-sequence odometry equal JAX's
`record_pose_errors` and `evaluate_vo_odometry` through its
`make_pose_forward` with the same weights (float32, `train.mixed_prec`
off; to 1e-4, relative for the odometry but the RPE rotation, 1e-3: the
arccos of a near-identity rotation, half a degree here, magnifies the two
frameworks' float32 pose differences). Then `--save-pose` writes both
splits' pose stacks, which equal JAX's `save_vo_pred_poses` to 1e-4, the VO
loader reads back, and a `pred_pose_online=False` training epoch consumes.
"""

import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import random_variables

from deep_sfm_revisited_tpu import cli as jcli
from deep_sfm_revisited_tpu import data as jdata
from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models.sfmnet import SFMNet as JSFMNet
from deep_sfm_revisited_tpu.train import pose_eval as jpe
from deep_sfm_revisited_tpu_torch import cli
from deep_sfm_revisited_tpu_torch.data import KittiVODataset, Compose, Normalize
from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_vo_tree
from deep_sfm_revisited_tpu_torch.utils.weights import jax_params_to_torch

torch.set_num_threads(2)
HW = (64, 128)
OVER = {"pose.estimator": "POSENET", "flow.estimator": "PWC", "data.pad_multiple": 64,
        "train.mixed_prec": False, "depth.nlabel": 8, "data.train_size": HW}
ERRORS = {"rot_err", "trans_dist", "trans_angle", "rot_err_fw", "trans_dist_fw",
          "trans_angle_fw"}


def _argv(root, out, *extra, over=OVER):
    return ["--data", root, "--cfg", "kitti", "--dataset", "kitti_vo", "--out", str(out),
            "--workers", "1", *extra, "--override", *[f"{k}={v}" for k, v in over.items()]]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(tree root, port checkpoint, JAX record report, JAX odometry, JAX
    diag pose forward)."""
    root = str(tmp_path_factory.mktemp("vo"))
    write_kitti_vo_tree(root, seqs=(0, 9, 10), n_frames=4, hw=HW)
    cfg = JConfig.kitti().override(**OVER)
    net = JSFMNet(cfg)
    x = jnp.zeros((1, *HW, 3), jnp.float32)
    variables = random_variables(lambda r, t, k: net.init(jax.random.PRNGKey(0), r, t, k),
                                 x, x, jnp.eye(3)[None], seed=11)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    fwd = jcli.make_pose_forward(cfg, state, diag=True)
    tf = jdata.Compose([jdata.Normalize()])
    loader = jdata.BatchLoader(jdata.KittiVODataset(root, train=False, transform=tf), 1,
                               shuffle=False, workers=1, pad_multiple=64, drop_last=False)
    want = jpe.record_pose_errors(loader, fwd, jax.random.PRNGKey(0),
                                  min_matches=cfg.pose.min_matches)
    odo = jpe.evaluate_vo_odometry(jdata.KittiVODataset(root, train=False, transform=tf),
                                   lambda *a: fwd(*a)[0], jax.random.PRNGKey(0), pad_multiple=64)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "weights.pt")
    torch.save({"model": jax_params_to_torch(variables, flow_estimator="PWC")}, ckpt)
    return root, ckpt, want, odo, fwd


def test_record_pose_matches_jax(setup, tmp_path):
    root, ckpt, want, odo, _ = setup
    got = cli.main(_argv(root, tmp_path, "--record-pose", "--pretrained", ckpt), device="cpu")
    assert (tmp_path / "kitti" / "config.yaml").exists()
    assert set(got) == ERRORS | {"odometry"} and set(want) == ERRORS
    for k in ERRORS:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    assert sorted(got["odometry"]) == sorted(odo) == [9, 10]
    for seq, rep in odo.items():
        for k, rtol in (("ate_rmse", 1e-4), ("rpe_trans", 1e-4), ("rpe_rot_deg", 1e-3)):
            np.testing.assert_allclose(got["odometry"][seq][k], rep[k], rtol=rtol, atol=1e-6,
                                       err_msg=f"{seq} {k}")
        assert got["odometry"][seq]["frames_scored"] == rep["frames_scored"] == 4


def test_save_pose_round_trips_into_training(setup, tmp_path):
    src, ckpt, _, _, fwd = setup
    roots = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for r in roots.values():
        shutil.copytree(src, r)
    written = cli.main(_argv(roots["torch"], tmp_path / "out", "--save-pose", "--pretrained",
                             ckpt), device="cpu")
    assert sorted(written) == [0, 9, 10]
    tf = jdata.Compose([jdata.Normalize()])
    for train in (True, False):
        jpe.save_vo_pred_poses(jdata.KittiVODataset(roots["jax"], train=train, transform=tf),
                               lambda *a: fwd(*a)[0], roots["jax"], jax.random.PRNGKey(0),
                               pad_multiple=64)
    for seq in (0, 9, 10):
        for d in ("fw", "bw"):
            name = os.path.join("pred_poses", f"{seq:02d}_{d}.npy")
            got, want = (np.load(os.path.join(roots[k], name)) for k in ("torch", "jax"))
            assert got.shape == (4, 3, 4) and got.dtype == np.float32
            assert np.abs(got[:3]).max() > 0
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)
    # the VO loader hands the saved backward pose of a pair to training
    ds = KittiVODataset(roots["torch"], train=True, transform=Compose([Normalize()]))
    bw = np.load(os.path.join(roots["torch"], "pred_poses", "00_bw.npy"))
    np.testing.assert_array_equal(ds[1]["pred_pose"], bw[1])
    over = dict(OVER, **{"pred_pose_online": False, "pose.estimator": "RANSAC"})
    recs = cli.main(_argv(roots["torch"], tmp_path / "train", "-b", "1", "--epochs", "1",
                          over=over), device="cpu")
    assert len(recs) == 1 and np.isfinite(recs[0]["train_loss"]) and recs[0]["step"] == 4
