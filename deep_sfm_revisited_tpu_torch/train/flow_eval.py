"""Flow-estimator evaluation (port of `deep_sfm_revisited_tpu/train/flow_eval.py`).

The reference's `models/RAFT/evaluate.py` (`validate_chairs` /
`validate_sintel` / `validate_kitti`, `:75-131`, and the benchmark
submission writers, `:22-74`): EPE and Fl-all over a flow dataset, and
Sintel / KITTI submission files through `data/flow_io.py`. Any flow
estimator of the `(pair (1, H, W, 6)) -> flow (1, H, W, 2)` contract works.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch

from deep_sfm_revisited_tpu_torch.data.loader import pad_to_multiple


def make_flow_forward(model: torch.nn.Module, cfg) -> Callable:
    """The eval-mode forward of a flow network `model` (in bf16 autocast
    where `train.mixed_prec` is set): a (1, H, W, 6) numpy pair -> the
    (1, H, W, 2) float32 numpy flow. Inputs move to the model's device."""
    dev = next(model.parameters()).device

    def forward(pair: np.ndarray) -> np.ndarray:
        model.eval()
        with torch.no_grad(), torch.autocast(device_type=dev.type, dtype=torch.bfloat16,
                                             enabled=cfg.train.mixed_prec):
            flow, _ = model(torch.from_numpy(np.ascontiguousarray(pair, np.float32)).to(dev))
        return flow.float().cpu().numpy()

    return forward


def _padded_pair(sample, multiple: int):
    h, w = sample["ref"].shape[:2]
    pair = np.concatenate([pad_to_multiple(sample["ref"], multiple),
                           pad_to_multiple(sample["target"], multiple)], axis=-1)
    return pair[None].astype(np.float32), (h, w)


def evaluate_flow_dataset(forward: Callable, dataset, pad_multiple: int = 64,
                          max_items: int | None = None) -> Dict[str, float]:
    """EPE and KITTI's Fl-all (the share of valid pixels whose error is above
    3 px and above 5% of the GT's magnitude, in percent) over a dataset
    without augmentation, each pair padded to /pad_multiple and its flow
    cropped back (JAX `evaluate_flow_dataset`); pairs without a valid pixel
    are skipped. -> {epe, f1_all, n}."""
    epes, out_frac = [], []
    n = len(dataset) if max_items is None else min(len(dataset), max_items)
    for i in range(n):
        s = dataset[i]
        pair, (h, w) = _padded_pair(s, pad_multiple)
        flow = np.asarray(forward(pair))[0, :h, :w]
        gt = s["flow_gt"][:h, :w]
        valid = np.asarray(s["flow_valid"])[:h, :w] > 0.5
        err = np.linalg.norm(flow - gt, axis=-1)
        mag = np.linalg.norm(gt, axis=-1)
        if valid.any():
            epes.append(err[valid].mean())
            out_frac.append(((err > 3.0) & (err > 0.05 * mag))[valid].mean())
    return {"epe": float(np.mean(epes)) if epes else float("nan"),
            "f1_all": float(100 * np.mean(out_frac)) if out_frac else float("nan"),
            "n": len(epes)}


def create_sintel_submission(forward: Callable, dataset, out_dir: str,
                             pad_multiple: int = 64) -> None:
    """.flo predictions in the Sintel submission layout (JAX
    `create_sintel_submission`)."""
    from deep_sfm_revisited_tpu_torch.data.flow_io import write_flo

    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(dataset)):
        pair, (h, w) = _padded_pair(dataset[i], pad_multiple)
        write_flo(os.path.join(out_dir, f"frame_{i:04d}.flo"),
                  np.asarray(forward(pair))[0, :h, :w])


def create_kitti_submission(forward: Callable, dataset, out_dir: str,
                            pad_multiple: int = 64) -> None:
    """16-bit PNG predictions in the KITTI submission layout (JAX
    `create_kitti_submission`)."""
    from deep_sfm_revisited_tpu_torch.data.flow_io import write_flow_kitti

    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(dataset)):
        pair, (h, w) = _padded_pair(dataset[i], pad_multiple)
        write_flow_kitti(os.path.join(out_dir, f"{i:06d}_10.png"),
                         np.asarray(forward(pair))[0, :h, :w])
