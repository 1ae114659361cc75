"""Pose recording and sequence-pose saving (port of `train/pose_eval.py`).

  * `record_pose_errors` ≙ the RECORD_POSE branch of `validate`
    (`main.py:504-530`): run the model's early-return pose path on every
    pair, forward and backward, and average the DeMoN motion errors;
  * `save_sequence_poses`, `save_vo_pred_poses`, `save_raw_pred_poses` ≙
    `save_pose` (`main.py:636-703`): per-pair [pose_fw; pose_bw] arrays in
    the layouts the loaders read back as pre-computed training poses
    (`pred_pose_online=False`);
  * `evaluate_vo_odometry` / `trajectory_from_saved`: chained trajectories
    scored by `train/odometry.py` in place of the external kitti-odom-eval.

`pose_forward(ref, target, K, generator)` takes the collated batch's arrays
as CPU tensors and returns the (B, 3, 4) pose, or `(pose, num_matches)`
(the diag form); `cli.make_pose_forward` builds it around the model, which
moves the inputs to its device. Where the JAX functions split a key per
call, the port hands every call the one `torch.Generator`, which advances
call by call. File names, layouts and report keys are the JAX package's.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Callable, Dict, List

import numpy as np
import torch

from deep_sfm_revisited_tpu_torch.ops.rotations import invert_pose
from deep_sfm_revisited_tpu_torch.train.metrics import motion_errors
from deep_sfm_revisited_tpu_torch.train.odometry import chain_poses, evaluate_trajectory


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _inputs(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(batch[k]))
                 for k in ("ref", "target", "intrinsics"))


def _both_directions(pose_forward, batch, generator):
    """(pose_bw, pose_fw): the loader's (ref, target) orientation, then the
    images swapped (not the matrix inverse: `main.py:682-683`)."""
    ref, tgt, K = _inputs(batch)
    return pose_forward(ref, tgt, K, generator), pose_forward(tgt, ref, K, generator)


def record_pose_errors(loader, pose_forward: Callable, generator: torch.Generator,
                       logger=None, min_matches: int = 0) -> Dict[str, float]:
    """Mean (rot, trans-dist, trans-angle) errors over `loader`, in both pair
    directions (JAX `pose_eval.py:34-100`).

    The loader's (ref, target, pose_gt) orientation is the backward
    direction (the unsuffixed keys); the forward pass swaps the images and is
    scored against the rigid inverse of pose_gt (`_fw` keys). With the diag
    form, `num_matches` (the mean confident-candidate count) and
    `uniform_fallback` (the share of images under `min_matches`) join them.
    """
    errs_fw: List[np.ndarray] = []
    errs_bw: List[np.ndarray] = []
    match_counts: List[np.ndarray] = []
    for batch in loader:
        pred_bw, pred_fw = _both_directions(pose_forward, batch, generator)
        if isinstance(pred_bw, tuple):   # diag form carries num_matches
            pred_bw, nm = pred_bw
            pred_fw, _ = pred_fw
            if nm is not None:
                match_counts.append(_np(nm))
        gt_bw = torch.from_numpy(np.ascontiguousarray(batch["pose_gt"]))
        for errs, pred, gt in ((errs_bw, pred_bw, gt_bw), (errs_fw, pred_fw, invert_pose(gt_bw))):
            r, td, ta = motion_errors(pred.detach().cpu(), gt)
            errs.append(np.stack([_np(r), _np(td), _np(ta)], axis=-1))
    agg_bw = np.concatenate(errs_bw, axis=0).mean(axis=0)
    agg_fw = np.concatenate(errs_fw, axis=0).mean(axis=0)
    out = {
        "rot_err": float(agg_bw[0]), "trans_dist": float(agg_bw[1]),
        "trans_angle": float(agg_bw[2]),
        "rot_err_fw": float(agg_fw[0]), "trans_dist_fw": float(agg_fw[1]),
        "trans_angle_fw": float(agg_fw[2]),
    }
    if match_counts:
        nm = np.concatenate(match_counts, axis=0).astype(np.float64)
        out["num_matches"] = float(nm.mean())
        out["uniform_fallback"] = float((nm < min_matches).mean())
    if logger is not None:
        logger.info(f"pose errors: {out}")
    return out


def save_sequence_poses(loader, pose_forward: Callable, out_dir: str,
                        generator: torch.Generator) -> List[str]:
    """Per-pair [pose_fw; pose_bw] .npy files named
    `{seq:02d}_{frame_id1:06d}_{frame_id:06d}.npy` (by both frame ids, so a
    sequence-boundary fallback pair does not collide with the forward pair
    ending at the same frame), or by a running count where the batch has no
    ids (JAX `pose_eval.py:103-140`)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for batch in loader:
        pose_bw, pose_fw = (_np(p) for p in _both_directions(pose_forward, batch, generator))
        seq, fid, fid1 = batch.get("seq"), batch.get("frame_id"), batch.get("frame_id1")
        for b in range(pose_bw.shape[0]):
            name = (f"{int(seq[b]):02d}_{int(fid1[b]):06d}_{int(fid[b]):06d}.npy"
                    if seq is not None and fid is not None and fid1 is not None
                    else f"{len(written):06d}.npy")
            path = os.path.join(out_dir, name)
            np.save(path, np.stack([pose_fw[b], pose_bw[b]]))
            written.append(path)
    return written


def _batched_pairs(dataset, indices, batch_size, pad_multiple=128):
    """Collate dataset samples into padded inference batches."""
    from deep_sfm_revisited_tpu_torch.data.loader import collate

    for s in range(0, len(indices), batch_size):
        chunk = [dataset[int(i)] for i in indices[s:s + batch_size]]
        yield collate(chunk, pad_multiple=pad_multiple), chunk


def save_vo_pred_poses(dataset, pose_forward: Callable, root: str, generator: torch.Generator,
                       batch_size: int = 1, pad_multiple: int = 128) -> Dict[int, str]:
    """Per-sequence stacks `pred_poses/{seq:02d}_fw.npy` and `_bw.npy`
    (float32, (n_frames, 3, 4), indexed by the pair's first frame id, zero
    where no pair starts), the layout the VO loader reads (JAX
    `pose_eval.py:153-194`). `dataset`: a KittiVODataset without random
    augmentation."""
    acc: Dict[int, Dict[int, np.ndarray]] = defaultdict(dict)
    nframes: Dict[int, int] = defaultdict(int)
    for batch, chunk in _batched_pairs(dataset, range(len(dataset)), batch_size, pad_multiple):
        pose_bw, pose_fw = (_np(p) for p in _both_directions(pose_forward, batch, generator))
        for b, s in enumerate(chunk):
            seq, fid1 = int(s["seq"]), int(s["frame_id1"])
            acc[seq][fid1] = np.stack([pose_fw[b], pose_bw[b]])
            nframes[seq] = max(nframes[seq], fid1 + 1)

    out_dir = os.path.join(root, "pred_poses")
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[int, str] = {}
    for seq, by_frame in acc.items():
        fw = np.zeros((nframes[seq], 3, 4), np.float32)
        bw = np.zeros((nframes[seq], 3, 4), np.float32)
        for fid, fb in by_frame.items():
            fw[fid], bw[fid] = fb[0], fb[1]
        np.save(os.path.join(out_dir, f"{seq:02d}_fw.npy"), fw)
        np.save(os.path.join(out_dir, f"{seq:02d}_bw.npy"), bw)
        written[seq] = out_dir
    return written


def save_raw_pred_poses(dataset, pose_forward: Callable, root: str, generator: torch.Generator,
                        batch_size: int = 1, pad_multiple: int = 128) -> List[str]:
    """Per-frame [pose_fw; pose_bw] .npy files in the reference's
    pred_poses_fb layout (`<folder>/pred_poses_fb/{frame:010d}.npy`, read
    back by KittiRawDataset; JAX `pose_eval.py:197-232`). `dataset`: a
    KittiRawDataset with random_offset=False, random_fw_bw=False."""
    written: List[str] = []
    for batch, chunk in _batched_pairs(dataset, range(len(dataset)), batch_size, pad_multiple):
        pose_bw, pose_fw = (_np(p) for p in _both_directions(pose_forward, batch, generator))
        for b, s in enumerate(chunk):
            folder, frame = dataset.items[int(s["index"])][:2]
            out_dir = os.path.join(root, folder, "pred_poses_fb")
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"{int(frame):010d}.npy")
            np.save(path, np.stack([pose_fw[b], pose_bw[b]]))
            written.append(path)
    return written


RMSE_KEYS = {"ate_rmse", "rpe_trans", "rpe_rot_deg"}


def _aggregate(seg_reps) -> Dict[str, float]:
    """Frame-weighted aggregate of per-segment reports (JAX
    `pose_eval.py:271-319`): RMSE keys in the squared domain (the RMSE over
    every scored frame), the rest as weighted means, non-finite values left
    out; `per_length` merged frame-weighted per length."""
    rep: Dict[str, float] = {}
    for k in seg_reps[0][1]:
        if k == "per_length":
            continue
        vals = [(n, r[k]) for n, r in seg_reps if np.isfinite(r[k])]
        w = sum(n for n, _ in vals)
        if not w:
            rep[k] = float("nan")
        elif k in RMSE_KEYS or k.endswith("rmse"):
            rep[k] = float(np.sqrt(sum(n * v * v for n, v in vals) / w))
        else:
            rep[k] = sum(n * v for n, v in vals) / w
    merged: Dict[int, List] = {}
    for n, r in seg_reps:
        for L, (t_e, r_e) in r["per_length"].items():
            merged.setdefault(L, []).append((n, t_e, r_e))
    rep["per_length"] = {
        L: (sum(n * t for n, t, _ in v) / sum(n for n, _, _ in v),
            sum(n * r for n, _, r in v) / sum(n for n, _, _ in v))
        for L, v in sorted(merged.items())
    }
    return rep


def evaluate_vo_odometry(dataset, pose_forward: Callable, generator: torch.Generator,
                         batch_size: int = 1, pad_multiple: int = 128,
                         logger=None) -> Dict[int, Dict[str, float]]:
    """Odometry over a KittiVODataset without random augmentation (JAX
    `pose_eval.py:235-336`): the backward pose of every consecutive
    skip-pair, chained per sequence over every contiguous run of pairs,
    scored against the GT trajectory (ATE, RPE, the KITTI segment errors)
    and aggregated frame-weighted over the runs. -> {seq: report}, each
    with `n_segments` and `frames_scored`."""
    links = [i for i in range(len(dataset)) if dataset._pair_index(i)[1] == i + dataset.skip]
    rels: Dict[int, Dict[int, np.ndarray]] = defaultdict(dict)
    for batch, chunk in _batched_pairs(dataset, links, batch_size, pad_multiple):
        # backward pose: frame-(i+skip) camera expressed in frame-i coords
        pose_bw = _np(pose_forward(*_inputs(batch), generator))
        for b, s in enumerate(chunk):
            rels[int(s["seq"])][int(s["frame_id1"])] = pose_bw[b]
    report: Dict[int, Dict[str, float]] = {}
    for seq, by_frame in sorted(rels.items()):
        fids = sorted(by_frame)
        segments: List[List[int]] = [[fids[0]]]
        for a, b in zip(fids, fids[1:]):
            if b == a + dataset.skip:
                segments[-1].append(b)
            else:
                segments.append([b])
        seg_reps = []
        for seg in segments:
            est = chain_poses(np.stack([by_frame[f] for f in seg])).numpy()
            gt = dataset.poses[seq][seg[0]::dataset.skip][: len(est)]
            seg_reps.append((len(est), evaluate_trajectory(est, gt)))
        rep = _aggregate(seg_reps)
        rep["n_segments"] = len(segments)
        rep["frames_scored"] = sum(n for n, _ in seg_reps)
        if len(segments) > 1 and logger is not None:
            logger.warning(f"seq {seq:02d}: {len(segments)} disjoint segments (missing pairs "
                           "at the gaps) - metrics are the frame-weighted aggregate")
        report[seq] = rep
        if logger is not None:
            logger.info(f"seq {seq:02d}: ATE {rep['ate_rmse']:.3f} m, "
                        f"t_err {rep['t_err_pct']:.2f} %, "
                        f"r_err {rep['r_err_deg_per_100m']:.4f} deg/100m")
    return report


def trajectory_from_saved(out_dir: str, seq: int) -> np.ndarray:
    """Chain the saved backward poses of one sequence (`save_sequence_poses`'
    files `{seq}_{i}_{j}.npy`, j = i + skip; boundary fallback pairs, j < i,
    left out) into cam-to-world poses (N+1, 4, 4)."""
    links = {}
    for f in sorted(os.listdir(out_dir)):
        if not (f.startswith(f"{seq:02d}_") and f.endswith(".npy")):
            continue
        parts = f[:-4].split("_")
        if len(parts) != 3:
            continue
        i, j = int(parts[1]), int(parts[2])
        if j > i:
            links[i] = (j, np.load(os.path.join(out_dir, f))[1])
    rels = []
    t = min(links) if links else 0
    while t in links:
        j, bw = links[t]
        rels.append(bw)
        t = j
    return chain_poses(np.stack(rels)).numpy()
