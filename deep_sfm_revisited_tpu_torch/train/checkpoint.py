"""Checkpoints with partial (sub-tree) restore (port of
`deep_sfm_revisited_tpu/train/checkpoint.py:29-145`), by `torch.save`.

One file per epoch, `<directory>/<epoch>.pt`, holding the model's state
dict, the optimizer's, the step, the epoch and the config; the five newest
are kept (the JAX package's orbax `max_to_keep=5`), and the best epoch is
copied to `model_best.pt` (`main.py:772-775`). `restore_subtree` merges the
flow or depth network alone from a composite checkpoint or from one that
holds that network only (the reference's strict=False loads with their
prefix shim, `main.py:222-242`).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

from deep_sfm_revisited_tpu_torch.train.trainer import SUBTREES

KEEP = 5
_EPOCH_FILE = re.compile(r"^(\d+)\.pt$")


def _epochs(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := _EPOCH_FILE.match(f)))


def _file(directory: str, epoch: Optional[int]) -> str:
    """The checkpoint of `epoch` (the newest when None) under `directory`;
    `directory` may also name a checkpoint file itself."""
    if os.path.isfile(directory):
        return directory
    if epoch is None:
        epochs = _epochs(directory)
        if not epochs:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        epoch = epochs[-1]
    path = os.path.join(directory, f"{epoch}.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def save_checkpoint(directory: str, trainer, epoch: int, is_best: bool = False) -> str:
    """Write the trainer's model, optimizer and step, the epoch and the
    config for `epoch`; copy it to `model_best.pt` when best. Returns the
    file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{epoch}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(dict(trainer.state_dict(), epoch=epoch, config=trainer.cfg.to_dict()), tmp)
    os.replace(tmp, path)
    for old in _epochs(directory)[:-KEEP]:
        os.remove(os.path.join(directory, f"{old}.pt"))
    if is_best:
        shutil.copyfile(path, os.path.join(directory, "model_best.pt"))
    return path


def _load(path: str, device) -> dict:
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(directory: str, trainer, epoch: Optional[int] = None) -> int:
    """Restore the trainer's model, optimizer and step (the newest epoch by
    default); returns the restored epoch."""
    state = _load(_file(directory, epoch), next(trainer.model.parameters()).device)
    trainer.load_state_dict(state)
    return int(state["epoch"])


def restore_model(directory: str, model, epoch: Optional[int] = None) -> None:
    """Load only the model's weights and statistics (no optimizer state),
    for evaluation."""
    state = _load(_file(directory, epoch), next(model.parameters()).device)
    model.load_state_dict(state["model"], strict=True)


def restore_subtree(directory: str, model, subtree: str, epoch: Optional[int] = None) -> None:
    """Load one network, `subtree` "flow_net" or "depth_net", into `model`,
    leaving the rest untouched (`--pretrained-flow` / `--pretrained-depth`).
    The checkpoint may hold the whole composite (its keys under the
    network's prefix) or that network alone."""
    attr = SUBTREES[subtree]
    stored = _load(_file(directory, epoch), next(model.parameters()).device)["model"]
    prefix = f"{attr}."
    if any(k.startswith(prefix) for k in stored):
        stored = {k[len(prefix):]: v for k, v in stored.items() if k.startswith(prefix)}
    getattr(model, attr).load_state_dict(stored, strict=True)
