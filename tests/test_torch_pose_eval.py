"""The port's pose tools (`train/pose_eval.py`) against the JAX package's.

Both packages' `record_pose_errors`, `save_sequence_poses`,
`save_vo_pred_poses`, `save_raw_pred_poses`, `evaluate_vo_odometry` and
`trajectory_from_saved` are fed one deterministic pose function (numpy,
from the images and intrinsics alone, so both sides see the same poses for
the same inputs) over golden KITTI trees (`data/synthetic.py`), each side
reading the tree through its own data layer. The written files must hold
equal arrays, the reports agree to 1e-6 (relative; the motion errors are
float32 on both sides, and the predicted poses lie far enough from the GT
that their arccos is well conditioned). One VO sequence has a frame
removed, so its odometry is the frame-weighted aggregate of two runs.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu import data as jdata
from deep_sfm_revisited_tpu.train import pose_eval as jpe
from deep_sfm_revisited_tpu_torch import data as tdata
from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_raw_tree, write_kitti_vo_tree
from deep_sfm_revisited_tpu_torch.train import pose_eval as tpe

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-9)
MIN_MATCHES = 500


def _pose(ref, tgt, K):
    """A deterministic, direction-sensitive pose per pair (B, 3, 4) float32
    and a count (B,) standing in for num_matches."""
    ref, tgt, K = (np.asarray(a, np.float64) for a in (ref, tgt, K))
    d = (ref - tgt).mean(axis=(1, 2))                              # (B, 3)
    w = 0.3 + 2.0 * d + 0.01 * K[:, 0, 2:3]                        # rotation vector
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    k = w / th
    Kx = np.zeros((len(w), 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2], Kx[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    Kx = Kx - Kx.transpose(0, 2, 1)
    s, c = np.sin(th)[..., None], np.cos(th)[..., None]
    R = np.eye(3) + s * Kx + (1 - c) * Kx @ Kx
    t = np.stack([ref.mean(axis=(1, 2, 3)), tgt.std(axis=(1, 2, 3)), np.ones(len(w))], -1)
    count = (np.abs(ref).mean(axis=(1, 2, 3)) * 1e5).astype(np.int32) % 1000
    return np.concatenate([R, t[..., None]], -1).astype(np.float32), count


def _jax_fwd(diag=False):
    def fwd(ref, tgt, K, key):
        assert key.shape == (2,)
        pose, n = _pose(ref, tgt, K)
        return (jnp.asarray(pose), jnp.asarray(n)) if diag else jnp.asarray(pose)
    return fwd


def _torch_fwd(diag=False):
    def fwd(ref, tgt, K, generator):
        assert isinstance(generator, torch.Generator)
        pose, n = _pose(ref.numpy(), tgt.numpy(), K.numpy())
        return (torch.from_numpy(pose), torch.from_numpy(n)) if diag else torch.from_numpy(pose)
    return fwd


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.fixture(scope="module")
def vo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vo"))
    write_kitti_vo_tree(root, seqs=(0, 9, 10), n_frames=7, hw=(40, 64))
    os.remove(os.path.join(root, "sequences", "10", "image_2", "000003.png"))   # a gap
    return root


def _vo(pkg, root, train=False):
    return pkg.KittiVODataset(root, train=train, transform=pkg.Compose([pkg.Normalize()]))


def _loader(pkg, ds):
    return pkg.BatchLoader(ds, 2, shuffle=False, workers=1, pad_multiple=16, drop_last=False)


def _close_reports(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _close_reports(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **TOL)


def test_record_pose_errors(vo_root):
    want = jpe.record_pose_errors(_loader(jdata, _vo(jdata, vo_root)), _jax_fwd(diag=True),
                                  jax.random.PRNGKey(0), min_matches=MIN_MATCHES)
    got = tpe.record_pose_errors(_loader(tdata, _vo(tdata, vo_root)), _torch_fwd(diag=True),
                                 _gen(), min_matches=MIN_MATCHES)
    assert {"rot_err", "trans_dist", "trans_angle", "rot_err_fw", "trans_dist_fw",
            "trans_angle_fw", "num_matches", "uniform_fallback"} == set(got)
    assert 0 < got["uniform_fallback"] < 1
    _close_reports(got, want)


def test_record_pose_errors_plain_form(vo_root):
    want = jpe.record_pose_errors(_loader(jdata, _vo(jdata, vo_root)), _jax_fwd(),
                                  jax.random.PRNGKey(0))
    got = tpe.record_pose_errors(_loader(tdata, _vo(tdata, vo_root)), _torch_fwd(), _gen())
    assert "num_matches" not in got
    _close_reports(got, want)


def test_evaluate_vo_odometry_with_a_gap(vo_root):
    want = jpe.evaluate_vo_odometry(_vo(jdata, vo_root), _jax_fwd(), jax.random.PRNGKey(0),
                                    batch_size=2, pad_multiple=16)
    got = tpe.evaluate_vo_odometry(_vo(tdata, vo_root), _torch_fwd(), _gen(),
                                   batch_size=2, pad_multiple=16)
    assert sorted(got) == [9, 10]
    assert got[9]["n_segments"] == 1 and got[10]["n_segments"] == 2
    assert np.isfinite(got[10]["ate_rmse"])
    _close_reports(got, want)


def _arrays(root, sub, within=""):
    base = os.path.join(root, sub)
    return {os.path.relpath(os.path.join(d, f), base): np.load(os.path.join(d, f))
            for d, _, fs in os.walk(base) for f in fs if f.endswith(".npy") and within in d}


def _equal_trees(a, b):
    assert a and set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_save_vo_pred_poses(vo_root, tmp_path):
    roots = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for r in roots.values():
        shutil.copytree(vo_root, r)
    for train in (True, False):
        jw = jpe.save_vo_pred_poses(_vo(jdata, roots["jax"], train), _jax_fwd(), roots["jax"],
                                    jax.random.PRNGKey(0), pad_multiple=16)
        tw = tpe.save_vo_pred_poses(_vo(tdata, roots["torch"], train), _torch_fwd(),
                                    roots["torch"], _gen(), pad_multiple=16)
        assert sorted(tw) == sorted(jw)
    got = _arrays(roots["torch"], "pred_poses")
    assert set(got) == {f"{s:02d}_{d}.npy" for s in (0, 9, 10) for d in ("fw", "bw")}
    _equal_trees(got, _arrays(roots["jax"], "pred_poses"))


def test_save_sequence_poses_and_trajectory(vo_root, tmp_path):
    jw = jpe.save_sequence_poses(_loader(jdata, _vo(jdata, vo_root)), _jax_fwd(),
                                 str(tmp_path / "jax"), jax.random.PRNGKey(0))
    tw = tpe.save_sequence_poses(_loader(tdata, _vo(tdata, vo_root)), _torch_fwd(),
                                 str(tmp_path / "torch"), _gen())
    assert [os.path.basename(p) for p in tw] == [os.path.basename(p) for p in jw]
    _equal_trees(_arrays(str(tmp_path), "torch"), _arrays(str(tmp_path), "jax"))
    want = jpe.trajectory_from_saved(str(tmp_path / "jax"), 9)
    got = tpe.trajectory_from_saved(str(tmp_path / "torch"), 9)
    assert got.shape == (7, 4, 4) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_save_raw_pred_poses(tmp_path):
    src = str(tmp_path / "src")
    write_kitti_raw_tree(src, n_frames=5, hw=(40, 64), n_test=2)
    roots = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for r in roots.values():
        shutil.copytree(src, r)
    for train in (True, False):
        kw = dict(train=train, gt_depth_dir=None, random_offset=False, random_fw_bw=False)
        jds = jdata.KittiRawDataset(roots["jax"], transform=jdata.Compose([jdata.Normalize()]),
                                    **kw)
        tds = tdata.KittiRawDataset(roots["torch"], transform=tdata.Compose([tdata.Normalize()]),
                                    **kw)
        jw = jpe.save_raw_pred_poses(jds, _jax_fwd(), roots["jax"], jax.random.PRNGKey(0),
                                     batch_size=2, pad_multiple=16)
        tw = tpe.save_raw_pred_poses(tds, _torch_fwd(), roots["torch"], _gen(),
                                     batch_size=2, pad_multiple=16)
        assert [os.path.relpath(p, roots["torch"]) for p in tw] == \
            [os.path.relpath(p, roots["jax"]) for p in jw]
    got = _arrays(roots["torch"], "", "pred_poses_fb")
    assert len(got) == 5
    _equal_trees(got, _arrays(roots["jax"], "", "pred_poses_fb"))
