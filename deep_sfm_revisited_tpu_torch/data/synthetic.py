"""Analytic synthetic scenes with exact ground truth.

The PyTorch port's copy of `deep_sfm_revisited_tpu/data/synthetic.py` (the
port imports nothing of the JAX package); besides its imports it adds
`write_kitti_flow_tree`, a KITTI 2015 flow training tree of the same scenes.

The reference repo's only geometry test is a synthetic harness for the
CUDA RANSAC solver (`essential_matrix_main.cu`); nothing upstream can
validate the FULL product path (loaders -> transforms -> model ->
protocol) against known geometry. This module renders multi-plane
scenes with procedural world-anchored textures so that, for any camera
pose, the image, dense depth map and inter-frame optical flow are all
EXACT (closed form, no resampling):

  * a scene is a list of world-space planes `n . X = d` (visibility =
    nearest positive ray intersection);
  * the texture is a fixed sum of 3-D sinusoids evaluated at the world
    intersection point — both views of a surface point get the identical
    color, which is precisely the photometric-consistency assumption the
    SfM pipeline inverts;
  * two non-parallel planes give non-coplanar structure, so the
    five-point essential solve is non-degenerate (a single plane is the
    classic homography-degenerate case).

Used by the convergence suite (training the shipped recipe on scenes
whose abs_rel floor is known) and by `write_kitti_raw_tree` /
`write_kitti_vo_tree`, which render a miniature golden dataset in the
real KITTI directory formats (≙ the trees `KITTI_loader.py:88,270`
consume) for end-to-end CLI regression pins.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Plane:
    """World-space plane n . X = d (n need not be unit)."""

    n: Tuple[float, float, float]
    d: float


def default_planes(cam_height: float = 1.5, wall_z: float = 18.0,
                   side_x: float = 8.0) -> List[Plane]:
    """A KITTI-like arrangement (camera coords: x right, y DOWN,
    z forward): a ground plane under the camera, a back wall, and a
    slanted side wall — three mutually non-parallel planes."""
    return [
        Plane((0.0, 1.0, 0.0), cam_height),        # ground: y = +1.5
        Plane((0.0, 0.0, 1.0), wall_z),            # back wall: z = 18
        Plane((1.0, 0.0, 0.25), side_x),           # slanted side wall
    ]


def _texture(X: np.ndarray, seed: int = 0) -> np.ndarray:
    """Procedural world texture: X (..., 3) -> RGB in [0, 1].

    A fixed bank of 3-D sinusoids per channel (multi-scale frequencies
    so every image patch carries matchable structure at DICL/RAFT's
    coarse pyramid levels too)."""
    rng = np.random.default_rng(seed)
    nfreq = 10
    # band-limited: at the default focal/depths the highest frequency
    # stays well under image Nyquist, so bilinear sampling of the
    # rendered views is photo-consistent (like real band-limited images)
    freqs = rng.uniform(0.25, 2.5, (3, nfreq, 3))
    phases = rng.uniform(0, 2 * np.pi, (3, nfreq))
    amps = rng.uniform(0.5, 1.0, (3, nfreq)) / np.sqrt(nfreq)
    out = np.zeros(X.shape[:-1] + (3,), np.float32)
    for c in range(3):
        acc = np.zeros(X.shape[:-1], np.float64)
        for f in range(nfreq):
            acc += amps[c, f] * np.sin(X @ freqs[c, f] + phases[c, f])
        out[..., c] = acc
    # normalize to [0, 1] with a soft squash
    return (0.5 + 0.5 * np.tanh(out)).astype(np.float32)


def render(
    K: np.ndarray,
    cam_to_world: np.ndarray,
    hw: Tuple[int, int],
    planes: Sequence[Plane],
    seed: int = 0,
    far: float = 200.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render one camera -> (image (H,W,3) in [0,1], depth (H,W),
    world points (H,W,3)).

    `cam_to_world` is the (3, 4) [R|t] with X_world = R @ X_cam + t.
    Depth is the camera-frame z of the nearest positive plane hit
    (clipped to `far` where no plane is hit, which cannot happen with
    `default_planes`)."""
    h, w = hw
    R = np.asarray(cam_to_world[:, :3], np.float64)
    t = np.asarray(cam_to_world[:, 3], np.float64)
    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack([xs + 0.0, ys + 0.0, np.ones_like(xs, np.float64)], -1)
    dirs_cam = pix @ np.linalg.inv(np.asarray(K, np.float64)).T  # z = 1
    dirs_w = dirs_cam @ R.T
    best = np.full((h, w), far, np.float64)
    for p in planes:
        n = np.asarray(p.n, np.float64)
        denom = dirs_w @ n
        lam = np.where(np.abs(denom) > 1e-12,
                       (p.d - t @ n) / np.where(denom == 0, 1, denom),
                       np.inf)
        lam = np.where(lam > 1e-6, lam, np.inf)
        best = np.minimum(best, lam)
    depth = best  # dirs_cam has z == 1, so lambda IS camera depth
    X = t[None, None] + dirs_w * depth[..., None]
    return _texture(X, seed), depth.astype(np.float32), X


def exact_flow(
    K: np.ndarray,
    cam_to_world_ref: np.ndarray,
    cam_to_world_tgt: np.ndarray,
    X_ref: np.ndarray,
) -> np.ndarray:
    """Exact optical flow ref -> target from the ref view's world points
    (H, W, 3): project each into the target camera."""
    R = np.asarray(cam_to_world_tgt[:, :3], np.float64)
    t = np.asarray(cam_to_world_tgt[:, 3], np.float64)
    Xc = (X_ref - t[None, None]) @ R  # world -> target cam
    p = Xc @ np.asarray(K, np.float64).T
    p = p[..., :2] / p[..., 2:3]
    h, w = X_ref.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    base = np.stack([xs, ys], -1).astype(np.float64)
    return (p - base).astype(np.float32)


def relative_pose(cam_to_world_ref: np.ndarray,
                  cam_to_world_tgt: np.ndarray) -> np.ndarray:
    """(3, 4) transform X_tgt = R @ X_ref + t — the orientation
    `pose_gt` carries through the data pipeline (ref-cam coords ->
    target-cam coords; ≙ compute_deltaRT, KITTI_loader.py:76-84)."""
    Rr, tr = cam_to_world_ref[:, :3], cam_to_world_ref[:, 3]
    Rt, tt = cam_to_world_tgt[:, :3], cam_to_world_tgt[:, 3]
    R = Rt.T @ Rr
    t = Rt.T @ (tr - tt)
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float64)


def forward_trajectory(n: int, step: float = 0.6, yaw_rate: float = 0.01,
                       lateral: float = 0.02) -> np.ndarray:
    """(N, 3, 4) cam-to-world poses of a gently curving forward drive
    (KITTI-like ego-motion: dominant +z translation, slow yaw)."""
    poses = []
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(n):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses.append(np.concatenate([R, pos[:, None]], axis=1))
        fwd = R @ np.asarray([lateral * np.sin(0.7 * i), 0.0, 1.0])
        pos = pos + step * fwd / np.linalg.norm(fwd)
        yaw += yaw_rate
    return np.stack(poses)


def sparse_depth(depth: np.ndarray, row_stride: int = 4,
                 col_stride: int = 1, row_offset: int = 0) -> np.ndarray:
    """LiDAR-like sparsification: keep scan rows every `row_stride`
    (KITTI velodyne GT covers roughly the lower image in sparse rows);
    zeros elsewhere, zeros above the horizon band."""
    out = np.zeros_like(depth)
    h = depth.shape[0]
    rows = np.arange(row_offset + h // 3, h, row_stride)
    out[rows[:, None], ::col_stride] = depth[rows[:, None], ::col_stride]
    return out


def _write_png_u8(path: str, img01: np.ndarray) -> None:
    from deep_sfm_revisited_tpu_torch.utils.tb_events import encode_png

    with open(path, "wb") as f:
        f.write(encode_png((np.clip(img01, 0, 1) * 255).astype(np.uint8)))


def _write_png_u16(path: str, depth: np.ndarray) -> None:
    """KITTI depth PNG convention: uint16, value = depth * 256."""
    from deep_sfm_revisited_tpu_torch.data.png import write_png_u16

    write_png_u16(path, np.clip(depth * 256.0, 0, 65535).astype(np.uint16))


def write_kitti_vo_tree(
    root: str,
    seqs: Sequence[int] = (0, 9),
    n_frames: int = 6,
    hw: Tuple[int, int] = (64, 96),
    focal: float = 70.0,
    seed: int = 0,
) -> None:
    """Golden miniature KITTI odometry tree (sequences/NN/image_2,
    calib.txt P2 line, poses/NN.txt, RealDepth/NN/velodyne depth PNGs)
    rendered from the analytic scene — the exact directory layout
    `KITTIVOLoaderGT` (KITTI_loader.py:88-237) and our KittiVODataset
    consume, with every image/pose/depth mutually consistent."""
    h, w = hw
    K = np.asarray([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    planes = default_planes()
    for seq in seqs:
        img_dir = os.path.join(root, "sequences", f"{seq:02d}", "image_2")
        depth_dir = os.path.join(root, "RealDepth", f"{seq:02d}",
                                 "velodyne")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(depth_dir, exist_ok=True)
        os.makedirs(os.path.join(root, "poses"), exist_ok=True)
        traj = forward_trajectory(n_frames)
        rows = []
        for i in range(n_frames):
            img, depth, _ = render(K, traj[i], hw, planes,
                                   seed=seed + seq)
            _write_png_u8(os.path.join(img_dir, f"{i:06d}.png"), img)
            _write_png_u16(os.path.join(depth_dir, f"{i:06d}.png"),
                           sparse_depth(depth))
            rows.append(traj[i].reshape(-1))
        np.savetxt(os.path.join(root, "poses", f"{seq:02d}.txt"),
                   np.stack(rows))
        with open(os.path.join(root, "sequences", f"{seq:02d}",
                               "calib.txt"), "w") as f:
            p2 = np.concatenate([K, np.zeros((3, 1))], axis=1).reshape(-1)
            f.write("P2: " + " ".join(f"{v:.6e}" for v in p2) + "\n")


def write_kitti_raw_tree(
    root: str,
    date: str = "2011_09_26",
    drive: str = "2011_09_26_drive_0001_sync",
    n_frames: int = 6,
    hw: Tuple[int, int] = (64, 96),
    focal: float = 70.0,
    seed: int = 0,
    n_test: int = 2,
) -> None:
    """Golden miniature KITTI raw tree (date/drive/image_02/data PNGs,
    per-frame GT-depth PNGs in the official layout, calib + Eigen-style
    train/test split files) rendered from the analytic scene — the
    layout `KITTIRAWLoaderGT` (KITTI_loader.py:270-409) and our
    KittiRawDataset consume."""
    h, w = hw
    K = np.asarray([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    planes = default_planes()
    img_dir = os.path.join(root, date, drive, "image_02", "data")
    os.makedirs(img_dir, exist_ok=True)
    gt_dir = os.path.join(root, "gt_depth", drive, "proj_depth",
                          "groundtruth", "image_02")
    os.makedirs(gt_dir, exist_ok=True)
    traj = forward_trajectory(n_frames)
    for i in range(n_frames):
        img, depth, _ = render(K, traj[i], hw, planes, seed=seed)
        _write_png_u8(os.path.join(img_dir, f"{i:010d}.png"), img)
        _write_png_u16(os.path.join(gt_dir, f"{i:010d}.png"),
                       sparse_depth(depth))
    # the precomputed calib/pose dicts the loader prefers
    # (≙ KITTI_loader.py:303-304): calib keyed by date, poses keyed by
    # drive with (N, 4, 4) cam-to-world homogeneous transforms
    np.save(os.path.join(root, "kitti_raw_calib_dict.npy"),
            {date: K.astype(np.float64)}, allow_pickle=True)
    traj44 = np.tile(np.eye(4), (n_frames, 1, 1))
    traj44[:, :3, :] = traj
    np.save(os.path.join(root, "kitti_raw_pose_dict.npy"),
            {drive: traj44}, allow_pickle=True)
    # Eigen-style split files: "<date>/<drive> <frame> l"
    lines = [f"{date}/{drive} {i:010d} l" for i in range(n_frames)]
    with open(os.path.join(root, "train_files.txt"), "w") as f:
        f.write("\n".join(lines[n_test:]) + "\n")
    with open(os.path.join(root, "test_files.txt"), "w") as f:
        f.write("\n".join(lines[:n_test]) + "\n")


def write_kitti_flow_tree(root: str, n_pairs: int = 4, hw: Tuple[int, int] = (64, 96),
                          focal: float = 70.0, seed: int = 0) -> None:
    """Miniature KITTI 2015 flow training tree (`training/image_2/
    {i:06d}_10.png`, `_11.png`, `training/flow_occ/{i:06d}_10.png`) of
    consecutive views of the analytic scene on `forward_trajectory`: the
    flow is the exact one (`exact_flow`), a smooth field, written in KITTI's
    16-bit format (`data/flow_io.py::write_flow_kitti`) with a sparse valid
    mask, LiDAR-like rows, every second one below the top third, where the
    point lands inside the second frame (KITTI's `flow_occ` is semi-dense).
    The layout `data/flow_datasets.py::KITTIFlow` reads."""
    from deep_sfm_revisited_tpu_torch.data.flow_io import write_flow_kitti

    h, w = hw
    K = np.asarray([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    planes = default_planes()
    img_dir = os.path.join(root, "training", "image_2")
    flow_dir = os.path.join(root, "training", "flow_occ")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(flow_dir, exist_ok=True)
    traj = forward_trajectory(n_pairs + 1)
    img, _, X = render(K, traj[0], hw, planes, seed=seed)
    rows = np.zeros((h, w), bool)
    rows[h // 3::2] = True
    for i in range(n_pairs):
        nxt, _, X_nxt = render(K, traj[i + 1], hw, planes, seed=seed)
        flow = exact_flow(K, traj[i], traj[i + 1], X)
        ys, xs = np.mgrid[0:h, 0:w]
        tx, ty = xs + flow[..., 0], ys + flow[..., 1]
        valid = rows & (tx >= 0) & (tx <= w - 1) & (ty >= 0) & (ty <= h - 1)
        _write_png_u8(os.path.join(img_dir, f"{i:06d}_10.png"), img)
        _write_png_u8(os.path.join(img_dir, f"{i:06d}_11.png"), nxt)
        write_flow_kitti(os.path.join(flow_dir, f"{i:06d}_10.png"), flow, valid)
        img, X = nxt, X_nxt
