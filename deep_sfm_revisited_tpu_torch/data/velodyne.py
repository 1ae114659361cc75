"""Velodyne LiDAR -> camera-2 depth-map projection.

The PyTorch port's copy of `deep_sfm_revisited_tpu/data/velodyne.py` (the
port imports nothing of the JAX package): scan reading, calibration, the
closest-depth projection, and the offline VO-sequence exporter
(`lidar_to_depth.py`), in numpy only (no C++ library, no imageio: the
frame's size comes from its PNG header and the depth maps are written by
`data/png.py`). Run the exporter as

    python -m deep_sfm_revisited_tpu_torch.data.velodyne --root /path/KITTI_odometry [--seqs 00 01]

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


# ---------------------------------------------------------------------
# Offline VO-sequence exporter (≙ `lidar_to_depth.py:14-52`): project
# every velodyne scan of an odometry sequence into a uint16/256 PNG
# under RealDepth/<seq>/velodyne/, the tree KittiVODataset consumes.
# The reference exporter's conventions differ from generate_depth_map's
# and are reproduced exactly: P2 @ Tr from the sequence calib.txt,
# valid mask u,v > 0 & round(u,v) < (W,H) & 0 < z < 1000, pixel index
# round() WITHOUT the -1 shift, last-point-wins (no closest-depth
# de-dup), clamp-to-zero outside uint16 range (lidar_to_depth.py:30-46).


def odometry_calib(calib_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(P2 (3,4), Tr (4,4)) from an odometry sequences/<seq>/calib.txt."""
    calib = read_calib_file(calib_path)
    P2 = calib["P2"].reshape(3, 4)
    Tr = np.eye(4)
    Tr[:3] = calib["Tr"].reshape(3, 4)
    return P2, Tr


def export_depth_png(points: np.ndarray, M: np.ndarray,
                     shape: Tuple[int, int]) -> np.ndarray:
    """One scan -> uint16 depth*256 image, reference-exporter semantics
    (lidar_to_depth.py:33-46)."""
    h, w = shape
    res = M @ points.T  # (3, N)
    z = res[2]
    u = res[0] / z
    v = res[1] / z
    valid = ((u > 0) & (np.round(u) < w) & (v > 0) & (np.round(v) < h)
             & (z > 0) & (z < 1000))
    ui = np.round(u[valid]).astype(np.uint32)
    vi = np.round(v[valid]).astype(np.uint32)
    depth = np.zeros((h, w), np.float64)
    depth[vi, ui] = z[valid]  # last point wins, as the reference
    d16 = depth * 256.0
    d16[(d16 < 0) | (d16 > 65535)] = 0
    return d16.astype(np.uint16)


def export_sequence(root: str, seq: str, out_subdir: str = "RealDepth",
                    verbose: bool = False) -> int:
    """Export every scan of sequences/<seq>/velodyne/*.bin. The image size
    comes from the matching image_2 frame's PNG header; a scan without a
    frame is skipped. Returns the number of files written."""
    import glob

    from deep_sfm_revisited_tpu_torch.data.png import probe_png, write_png_u16

    P2, Tr = odometry_calib(os.path.join(root, "sequences", seq, "calib.txt"))
    M = P2 @ Tr
    bins = sorted(glob.glob(os.path.join(root, "sequences", seq, "velodyne", "*.bin")))
    n = 0
    for b in bins:
        frame = os.path.splitext(os.path.basename(b))[0]
        img = os.path.join(root, "sequences", seq, "image_2", frame + ".png")
        if not os.path.exists(img):
            continue  # no camera frame -> no depth target size
        with open(img, "rb") as f:
            meta = probe_png(f.read(64))
        if meta is None:
            raise ValueError(f"{img}: not a PNG with an IHDR of a known colour type")
        d16 = export_depth_png(load_velodyne_points(b), M, meta[:2])
        out = os.path.join(root, out_subdir, seq, "velodyne", frame + ".png")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        write_png_u16(out, d16)
        n += 1
        if verbose and n % 100 == 0:
            print(f"seq {seq}: {n}/{len(bins)}", flush=True)
    return n


def _main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Export KITTI-VO velodyne scans to RealDepth/ PNGs "
                    "(offline, ≙ lidar_to_depth.py)")
    p.add_argument("--root", required=True, help="KITTI odometry root")
    p.add_argument("--seqs", nargs="*", default=[f"{i:02d}" for i in range(11)])
    p.add_argument("--out-subdir", default="RealDepth")
    args = p.parse_args(argv)
    total = 0
    for seq in args.seqs:
        n = export_sequence(args.root, seq, args.out_subdir, verbose=True)
        print(f"seq {seq}: wrote {n} depth maps", flush=True)
        total += n
    print(f"done: {total} files", flush=True)


if __name__ == "__main__":
    _main()
