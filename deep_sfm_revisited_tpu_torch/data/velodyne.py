"""Velodyne LiDAR -> camera-2 depth-map projection.

The PyTorch port's copy of the eval-side part of
`deep_sfm_revisited_tpu/data/velodyne.py` (the port imports nothing of the
JAX package): scan reading, calibration and the closest-depth projection,
in numpy only (no C++ library). The offline VO-sequence exporter
(`lidar_to_depth.py`) is not ported.

Rebuild of `kitti_utils.py` (`load_velodyne_points` `:7`,
`read_calib_file` `:25` via utils, `generate_depth_map` `:44`) and the
offline exporter `lidar_to_depth.py:14-52`: project each scan through the
P_rect @ R_rect @ T_velo2cam calibration chain, keep the closest depth
per pixel (duplicate-projection de-dup).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def load_velodyne_points(path: str) -> np.ndarray:
    """Read a KITTI .bin scan -> (N, 4) float32 with reflectance -> 1."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    pts[:, 3] = 1.0
    return pts


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    """Parse a 'key: v v v ...' calibration text file."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                out[key.strip()] = np.array(
                    [float(x) for x in value.split()], dtype=np.float64
                )
            except ValueError:
                pass
    return out


def velo_to_cam_transform(calib_dir: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(P_rect_02 (3,4), R_rect_00 (4,4), T_velo2cam (4,4)) for a drive."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_f = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    T = np.eye(4)
    T[:3, :3] = velo2cam_f["R"].reshape(3, 3)
    T[:3, 3] = velo2cam_f["T"]
    R = np.eye(4)
    R[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P = cam2cam["P_rect_02"].reshape(3, 4)
    return P, R, T


def project_depth(
    points: np.ndarray,
    P: np.ndarray,
    R: np.ndarray,
    T: np.ndarray,
    shape: Tuple[int, int],
) -> np.ndarray:
    """Project (N, 4) homogeneous velodyne points to an (H, W) depth map.

    Closest-depth wins per pixel, with the same duplicate handling as
    `generate_depth_map` (`kitti_utils.py:75-90`).
    """
    h, w = shape
    pts = points[points[:, 0] >= 1e-3]  # in front of the sensor
    cam = (P @ R @ T @ pts.T).T  # (N, 3)
    z = cam[:, 2]
    u = cam[:, 0] / z
    v = cam[:, 1] / z
    # the reference rounds with (int) after -1 (kitti_utils.py:72-74)
    ui = np.round(u).astype(np.int64) - 1
    vi = np.round(v).astype(np.int64) - 1
    ok = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (z > 0)
    ui, vi, z = ui[ok], vi[ok], z[ok]

    depth = np.zeros((h, w), np.float32)
    # closest-depth de-dup: sort descending by depth so nearer points
    # overwrite farther ones
    order = np.argsort(-z)
    depth[vi[order], ui[order]] = z[order]
    return depth


def generate_depth_map(calib_dir: str, velo_path: str, shape: Tuple[int, int]):
    """Full pipeline for one frame (≙ `generate_depth_map`, kitti_utils.py:44).

    In numpy only.
    """
    P, R, T = velo_to_cam_transform(calib_dir)
    return project_depth(load_velodyne_points(velo_path), P, R, T, shape)
