"""OXTS GPS/IMU -> camera-frame pose chains for KITTI raw drives.

The PyTorch port's verbatim copy of `deep_sfm_revisited_tpu/data/oxts.py`
(the port imports nothing of the JAX package).

The reference requires preprocessed `kitti_raw_pose_dict.npy` files
(`KITTI_loader.py:304`) produced by an external pykitti script; we parse
the raw OXTS recordings directly (standard Mercator-projection recipe, as
in pykitti) so an unmodified KITTI-raw download works end to end.

Produces cam0-frame cam-to-world (4, 4) poses compatible with
`compute_delta_rt`.
"""

from __future__ import annotations

import glob
import os

import numpy as np

EARTH_RADIUS = 6378137.0


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def load_oxts_poses(drive_dir: str) -> np.ndarray:
    """(N, 4, 4) IMU-frame cam-to-world poses for a drive directory."""
    files = sorted(
        glob.glob(os.path.join(drive_dir, "oxts", "data", "*.txt"))
    )
    if not files:
        raise FileNotFoundError(f"no oxts data under {drive_dir}")
    vals = np.stack([np.loadtxt(f) for f in files])  # (N, 30)
    lat, lon, alt = vals[:, 0], vals[:, 1], vals[:, 2]
    roll, pitch, yaw = vals[:, 3], vals[:, 4], vals[:, 5]

    scale = np.cos(lat[0] * np.pi / 180.0)
    tx = scale * lon * np.pi * EARTH_RADIUS / 180.0
    ty = scale * EARTH_RADIUS * np.log(
        np.tan((90.0 + lat) * np.pi / 360.0)
    )
    tz = alt
    t0 = np.array([tx[0], ty[0], tz[0]])

    poses = np.zeros((len(files), 4, 4))
    for i in range(len(files)):
        R = _rot_z(yaw[i]) @ _rot_y(pitch[i]) @ _rot_x(roll[i])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = np.array([tx[i], ty[i], tz[i]]) - t0
        poses[i, 3, 3] = 1.0
    return poses.astype(np.float32)
