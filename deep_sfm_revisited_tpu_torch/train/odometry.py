"""Odometry: relative-pose chaining and trajectory metrics (port of `train/odometry.py`).

The reference's pose workload saves per-frame [pose_fw; pose_bw] arrays
(`save_pose`, `main.py:636-703`) for the external kitti-odom-eval toolbox
(`README.md:69-71`); as the JAX package, the port scores them in-framework:

  * `chain_poses` integrates per-pair relative transforms into a
    trajectory, as a running product in float64 (the JAX package's
    associative scan forms the same prefix products in another order; the
    tests hold the two to 1e-12 relative in float64);
  * `align_umeyama` similarity-aligns trajectories (monocular scale);
  * `ate_rmse` / `rpe` / `kitti_segment_errors` reproduce kitti-odom-eval's
    headline metrics, in host numpy (copied from the JAX module).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def chain_poses(rel_poses) -> torch.Tensor:
    """Integrate N relative transforms into N+1 cam-to-world poses.

    rel_poses (N, 3, 4), a tensor or an array: pose of frame i+1 expressed
    in frame i (cam_{i+1}-to-cam_i). Returns (N+1, 4, 4) with pose[0] = I,
    in the input's floating dtype, the prefix products T_0 T_1 ... T_k taken
    in float64.
    """
    rel = torch.as_tensor(rel_poses)
    dtype = rel.dtype if rel.is_floating_point() else torch.float32
    N = rel.shape[0]
    T = torch.eye(4, dtype=torch.float64, device=rel.device).repeat(N + 1, 1, 1)
    T[1:, :3, :] = rel.to(torch.float64)
    for k in range(2, N + 1):
        T[k] = T[k - 1] @ T[k]
    return T.to(dtype)


def align_umeyama(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Similarity alignment est -> gt over (N, 3) positions.

    Returns (scale, R, t) minimizing ||gt - (s R est + t)||^2 (Umeyama).
    Runs on host numpy (eval-time only; needs full SVD).
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    cov = g.T @ e / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (e**2).sum() / len(est)
    s = float(np.trace(np.diag(D) @ S) / var_e) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_traj: np.ndarray, gt_traj: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE of aligned positions), metres.

    est_traj/gt_traj: (N, 4, 4) or (N, 3, 4) cam-to-world poses.
    """
    p_e = np.asarray(est_traj)[:, :3, 3]
    p_g = np.asarray(gt_traj)[:, :3, 3]
    if align:
        s, R, t = align_umeyama(p_e, p_g)
        p_e = (s * (R @ p_e.T)).T + t
    return float(np.sqrt(np.mean(np.sum((p_e - p_g) ** 2, axis=-1))))


def rpe(est_traj: np.ndarray, gt_traj: np.ndarray,
        delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over `delta`-frame intervals.

    Returns (trans_rmse_m, rot_rmse_deg) — kitti-odom-eval's RPE.
    """
    est = np.asarray(est_traj, np.float64)
    gt = np.asarray(gt_traj, np.float64)

    def to44(T):
        if T.shape[-2:] == (3, 4):
            out = np.tile(np.eye(4), (len(T), 1, 1))
            out[:, :3, :4] = T
            return out
        return T

    est, gt = to44(est), to44(gt)
    d_t, d_r = [], []
    for i in range(len(est) - delta):
        e_rel = np.linalg.inv(est[i]) @ est[i + delta]
        g_rel = np.linalg.inv(gt[i]) @ gt[i + delta]
        err = np.linalg.inv(g_rel) @ e_rel
        d_t.append(np.linalg.norm(err[:3, 3]))
        cos = (np.trace(err[:3, :3]) - 1) / 2
        d_r.append(np.degrees(np.arccos(np.clip(cos, -1, 1))))
    return float(np.sqrt(np.mean(np.square(d_t)))), float(
        np.sqrt(np.mean(np.square(d_r)))
    )


def trajectory_distances(traj: np.ndarray) -> np.ndarray:
    """Cumulative along-path distance (N,) of an (N, 4, 4)/(N, 3, 4)
    cam-to-world trajectory — the KITTI devkit's `trajectoryDistances`."""
    p = np.asarray(traj, np.float64)[:, :3, 3]
    seg = np.linalg.norm(np.diff(p, axis=0), axis=-1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def kitti_segment_errors(
    est_traj: np.ndarray,
    gt_traj: np.ndarray,
    lengths: Tuple[int, ...] = (100, 200, 300, 400, 500, 600, 700, 800),
    step: int = 10,
    align_scale: bool = False,
) -> Tuple[float, float, dict]:
    """KITTI odometry per-length segment errors (the devkit metric that the
    reference outsources to the external kitti-odom-eval toolbox,
    `README.md:69-71`).

    For every start frame (every `step` frames) and every segment length L
    reachable along the GT path, compares the relative transform over the
    segment and accumulates translation error ||t_err|| / L and rotation
    error angle(R_err) / L — the original C++ devkit's `calcSequenceErrors`.

    Returns (t_err_pct, r_err_deg_per_100m, per_length) where t_err_pct is
    the mean translation error in percent, r_err the mean rotation error in
    degrees per 100 m, and per_length maps L -> (t_err_pct, r_err) for the
    standard KITTI table. `align_scale=True` first rescales the estimated
    translations by the Umeyama similarity scale vs GT (monocular scale
    ambiguity — kitti-odom-eval's `--align scale` mode).
    """

    def to44(T):
        T = np.asarray(T, np.float64)
        if T.shape[-2:] == (3, 4):
            out = np.tile(np.eye(4), (len(T), 1, 1))
            out[:, :3, :4] = T
            return out
        return T

    est, gt = to44(est_traj), to44(gt_traj)
    if align_scale:
        s, _, _ = align_umeyama(est[:, :3, 3], gt[:, :3, 3])
        est = est.copy()
        est[:, :3, 3] *= s
    dist = trajectory_distances(gt)
    per_length = {L: [] for L in lengths}
    for first in range(0, len(gt), step):
        for L in lengths:
            # first frame whose path distance from `first` reaches L
            beyond = np.nonzero(dist > dist[first] + L)[0]
            if len(beyond) == 0:
                break
            last = int(beyond[0])
            d_gt = np.linalg.inv(gt[first]) @ gt[last]
            d_est = np.linalg.inv(est[first]) @ est[last]
            err = np.linalg.inv(d_est) @ d_gt
            t_err = np.linalg.norm(err[:3, 3]) / L
            cos = (np.trace(err[:3, :3]) - 1) / 2
            r_err = np.arccos(np.clip(cos, -1, 1)) / L
            per_length[L].append((t_err, r_err))
    table = {
        L: (100.0 * float(np.mean([e[0] for e in v])),
            100.0 * float(np.degrees(np.mean([e[1] for e in v]))))
        for L, v in per_length.items() if v
    }
    flat = [e for v in per_length.values() for e in v]
    if not flat:
        return float("nan"), float("nan"), table
    t_pct = 100.0 * float(np.mean([e[0] for e in flat]))
    r_deg = 100.0 * float(np.degrees(np.mean([e[1] for e in flat])))
    return t_pct, r_deg, table


def evaluate_trajectory(est_traj, gt_traj, align: bool = True) -> dict:
    """One-call odometry report: ATE + RPE + KITTI segment errors —
    everything the external kitti-odom-eval toolbox prints for a sequence."""
    t_pct, r_deg, table = kitti_segment_errors(
        est_traj, gt_traj, align_scale=align
    )
    rpe_t, rpe_r = rpe(est_traj, gt_traj)
    return {
        "ate_rmse": ate_rmse(est_traj, gt_traj, align=align),
        "rpe_trans": rpe_t,
        "rpe_rot_deg": rpe_r,
        "t_err_pct": t_pct,
        "r_err_deg_per_100m": r_deg,
        "per_length": table,
    }


def save_pose_predictions(path: str, poses_fw: np.ndarray,
                          poses_bw: np.ndarray) -> None:
    """Persist per-frame [pose_fw; pose_bw] stacks for reuse as
    pre-computed training poses (≙ `save_pose`, main.py:686-692)."""
    np.save(path, np.stack([poses_fw, poses_bw], axis=1))
