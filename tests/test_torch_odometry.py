"""The port's `train/odometry.py` against the JAX package's, on seeded trajectories.

Every function on the same inputs: `chain_poses` (the JAX associative scan
against the port's float64 running product: the same prefix products in
another order, held to 1e-12 relative in float64; a float32 input comes
back float32, to 1e-6), `align_umeyama` with and without scale, `ate_rmse`,
`rpe`, `trajectory_distances`, `kitti_segment_errors` (with and without
`align_scale`, on a trajectory long enough for the KITTI segment lengths),
`evaluate_trajectory` and `save_pose_predictions`, to 1e-6 in float64; a
gapped sequence is the pose tools' case (tests/test_torch_pose_eval.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.ops.rotations import angle_to_matrix
from deep_sfm_revisited_tpu.train import odometry as jodo
from deep_sfm_revisited_tpu_torch.train import odometry as todo

TOL = dict(rtol=1e-6, atol=1e-9)


def _rel_poses(n, seed, step=1.0):
    """n relative motions: mostly forward, small turns, noisy."""
    rng = np.random.RandomState(seed)
    ang = rng.randn(n, 3) * np.array([0.002, 0.02, 0.002])
    R = np.asarray(angle_to_matrix(jnp.asarray(ang)))
    t = np.stack([rng.randn(n) * 0.05, rng.randn(n) * 0.01, step + 0.1 * rng.randn(n)], 1)
    return np.concatenate([R, t[..., None]], axis=-1)


def _trajs(n=300, seed=0):
    gt = np.asarray(jodo.chain_poses(jnp.asarray(_rel_poses(n, seed))))
    noisy = _rel_poses(n, seed)
    noisy[:, :3, 3] *= 1.0 + 0.03 * np.random.RandomState(seed + 1).randn(n, 1)
    est = np.asarray(jodo.chain_poses(jnp.asarray(noisy)))
    return est, gt


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chain_poses(dtype):
    rel = _rel_poses(64, 1).astype(dtype)
    j = np.asarray(jodo.chain_poses(jnp.asarray(rel)))
    t = todo.chain_poses(rel)
    assert isinstance(t, torch.Tensor) and t.numpy().dtype == dtype and t.shape == (65, 4, 4)
    np.testing.assert_array_equal(t[0].numpy(), np.eye(4))
    tol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(t.numpy(), j, rtol=tol, atol=tol * np.abs(j).max())


@pytest.mark.parametrize("with_scale", [True, False])
def test_align_umeyama(with_scale):
    est, gt = _trajs(50)
    js, jR, jt = jodo.align_umeyama(est[:, :3, 3] * 0.7, gt[:, :3, 3], with_scale)
    ts, tR, tt = todo.align_umeyama(est[:, :3, 3] * 0.7, gt[:, :3, 3], with_scale)
    np.testing.assert_allclose(ts, js, **TOL)
    np.testing.assert_allclose(tR, jR, **TOL)
    np.testing.assert_allclose(tt, jt, **TOL)


@pytest.mark.parametrize("align", [True, False])
def test_ate_rpe_distances(align):
    est, gt = _trajs(80, seed=2)
    np.testing.assert_allclose(todo.ate_rmse(est, gt, align), jodo.ate_rmse(est, gt, align), **TOL)
    for delta in (1, 5):
        np.testing.assert_allclose(todo.rpe(est[:, :3], gt, delta), jodo.rpe(est[:, :3], gt, delta),
                                   **TOL)
    np.testing.assert_allclose(todo.trajectory_distances(gt), jodo.trajectory_distances(gt), **TOL)


@pytest.mark.parametrize("align_scale", [False, True])
def test_kitti_segment_errors(align_scale):
    est, gt = _trajs(300, seed=3)
    jt, jr, jtab = jodo.kitti_segment_errors(est, gt, align_scale=align_scale)
    tt, tr, ttab = todo.kitti_segment_errors(est, gt, align_scale=align_scale)
    assert len(ttab) >= 2 and set(ttab) == set(jtab)
    np.testing.assert_allclose([tt, tr], [jt, jr], **TOL)
    for L in jtab:
        np.testing.assert_allclose(ttab[L], jtab[L], **TOL)


def test_segment_errors_of_a_short_path_are_nan():
    est, gt = _trajs(20, seed=4)           # ~20 m: no 100 m segment
    jt, _, jtab = jodo.kitti_segment_errors(est, gt)
    tt, _, ttab = todo.kitti_segment_errors(est, gt)
    assert np.isnan(jt) and np.isnan(tt) and jtab == ttab == {}


def test_evaluate_trajectory_and_save(tmp_path):
    est, gt = _trajs(250, seed=5)
    j, t = jodo.evaluate_trajectory(est, gt), todo.evaluate_trajectory(est, gt)
    assert set(t) == set(j)
    for k in j:
        if k == "per_length":
            assert set(t[k]) == set(j[k])
            for L in j[k]:
                np.testing.assert_allclose(t[k][L], j[k][L], **TOL)
        else:
            np.testing.assert_allclose(t[k], j[k], **TOL)
    fw, bw = est[:10, :3].astype(np.float32), gt[:10, :3].astype(np.float32)
    jodo.save_pose_predictions(str(tmp_path / "j.npy"), fw, bw)
    todo.save_pose_predictions(str(tmp_path / "t.npy"), fw, bw)
    assert (tmp_path / "j.npy").read_bytes() == (tmp_path / "t.npy").read_bytes()
