"""Run logging.

The PyTorch port's copy of `deep_sfm_revisited_tpu/utils/logging.py` (the
port imports nothing of the JAX package); `MetricLogger.image` writes its
PNG with `tb_events.encode_png` instead of imageio.

Rebuild of `create_logger` (`main.py:708-715`), `AverageMeter`
(`main.py:751-769`), and the TensorBoardX scalar/image emits
(`main.py:390-450`) — here a dependency-light `MetricLogger` that writes
JSONL scalar streams (TensorBoard-convertible) and PNG images, since
tensorboardX is not in the image.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def create_logger(log_dir: str, tag: str) -> logging.Logger:
    """File + console logger (≙ `create_logger`, main.py:708-715)."""
    os.makedirs(log_dir, exist_ok=True)
    name = time.strftime(f"{tag}_%Y-%m-%d-%H-%M")
    logger = logging.getLogger(tag)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(message)s")
        fh = logging.FileHandler(os.path.join(log_dir, f"{name}.log"))
        fh.setFormatter(fmt)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(sh)
    return logger


class AverageMeter:
    """Running average (≙ `AverageMeter`, main.py:751-769)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __repr__(self):
        return f"{self.val:.4f} ({self.avg:.4f})"


class MetricLogger:
    """JSONL scalar stream + TensorBoard event file + PNG image dumps.

    The tfevents output (utils/tb_events.py, dependency-free) makes the
    run directory directly loadable by TensorBoard, matching the
    reference's tensorboardX artifact (`main.py:147-148,390-450`)."""

    def __init__(self, log_dir: str, name: str = "train",
                 tensorboard: bool = True):
        self.dir = os.path.join(log_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "scalars.jsonl"), "a")
        self._tb = None
        if tensorboard:
            from deep_sfm_revisited_tpu_torch.utils.tb_events import (
                TBEventWriter,
            )

            self._tb = TBEventWriter(self.dir)

    def scalar(self, tag: str, value, step: int):
        self._f.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step)})
            + "\n"
        )
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
            self._tb.flush()

    def scalars(self, values: Dict[str, float], step: int):
        for k, v in values.items():
            self.scalar(k, v, step)

    def image(self, tag: str, img, step: int):
        """PNG file + TensorBoard image pane (≙ writer.add_image,
        main.py:429-447). `img`: uint8 (H, W[, C])."""
        from deep_sfm_revisited_tpu_torch.utils.tb_events import encode_png

        path = os.path.join(self.dir, f"{tag.replace('/', '_')}_{step}.png")
        with open(path, "wb") as f:
            f.write(encode_png(img))
        if self._tb is not None:
            self._tb.add_image(tag, img, step)
            self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
