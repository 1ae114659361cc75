"""Flow-pretraining augmentation.

The PyTorch port's verbatim copy of `deep_sfm_revisited_tpu/data/flow_augment.py`
(the port imports nothing of the JAX package): the same `np.random.Generator`
gives the same samples bit for bit.

Rebuild of `augmentor.py` (`FlowAugmentor` `:16`, `SparseFlowAugmentor`
`:123`; duplicated under `models/RAFT/core/utils/augmentor.py`):
RAFT-style photometric jitter, eraser (occlusion simulation), random
rescale + crop + flips, with the sparse variant preserving valid masks by
coordinate remapping instead of interpolation. Host-side numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from deep_sfm_revisited_tpu_torch.data.transforms import (
    _resize_bilinear_np,
    _resize_nearest_np,
)


class FlowAugmentor:
    """Dense-flow augmentor (FlyingChairs/Things/Sintel)."""

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = True,
                 eraser_prob: float = 0.5, spatial_prob: float = 0.8,
                 stretch_prob: float = 0.8, max_stretch: float = 0.2,
                 asymmetric_color_prob: float = 0.2):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.eraser_prob = eraser_prob
        self.spatial_prob = spatial_prob
        self.stretch_prob = stretch_prob
        self.max_stretch = max_stretch
        self.asymmetric_color_prob = asymmetric_color_prob

    # --- photometric -----------------------------------------------------
    def _jitter(self, img, rng):
        b = rng.uniform(0.6, 1.4)
        c = rng.uniform(0.6, 1.4)
        s = rng.uniform(0.6, 1.4)
        x = img.astype(np.float32) * b
        mean = x.mean(axis=(0, 1), keepdims=True)
        x = (x - mean) * c + mean
        gray = x.mean(axis=-1, keepdims=True)
        x = gray + (x - gray) * s
        return np.clip(x, 0, 255)

    def color_transform(self, img1, img2, rng):
        if rng.random() < self.asymmetric_color_prob:
            return self._jitter(img1, rng), self._jitter(img2, rng)
        stacked = np.concatenate([img1, img2], axis=0)
        out = self._jitter(stacked, rng)
        return np.split(out, 2, axis=0)

    def eraser_transform(self, img1, img2, rng, bounds=(50, 100)):
        """Random rectangles of img2 replaced by its mean color
        (≙ augmentor.py eraser_transform)."""
        h, w = img1.shape[:2]
        if rng.random() < self.eraser_prob:
            mean = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(int(rng.integers(1, 3))):
                x0 = int(rng.integers(0, w))
                y0 = int(rng.integers(0, h))
                dx = int(rng.integers(bounds[0], bounds[1]))
                dy = int(rng.integers(bounds[0], bounds[1]))
                img2[y0 : y0 + dy, x0 : x0 + dx] = mean
        return img1, img2

    # --- spatial ---------------------------------------------------------
    def spatial_transform(self, img1, img2, flow, rng):
        ch, cw = self.crop_size
        h, w = img1.shape[:2]
        min_scale = np.maximum((ch + 8) / h, (cw + 8) / w)
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.stretch_prob:
            sx *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        sx, sy = max(sx, min_scale), max(sy, min_scale)

        if rng.random() < self.spatial_prob:
            nh, nw = int(round(h * sy)), int(round(w * sx))
            img1 = _resize_bilinear_np(img1, (nh, nw))
            img2 = _resize_bilinear_np(img2, (nh, nw))
            flow = _resize_bilinear_np(flow, (nh, nw))
            flow = flow * np.array([nw / w, nh / h], np.float32)

        if self.do_flip:
            if rng.random() < 0.5:  # h-flip
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
            if rng.random() < 0.1:  # v-flip
                img1 = img1[::-1]
                img2 = img2[::-1]
                flow = flow[::-1] * np.array([1.0, -1.0], np.float32)

        h, w = img1.shape[:2]
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        sl = np.s_[y0 : y0 + ch, x0 : x0 + cw]
        return img1[sl], img2[sl], flow[sl]

    def __call__(self, img1, img2, flow, rng=None):
        rng = rng or np.random.default_rng()
        img1, img2 = self.color_transform(
            img1.astype(np.float32), img2.astype(np.float32), rng
        )
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow = self.spatial_transform(img1, img2, flow, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


class SparseFlowAugmentor(FlowAugmentor):
    """Sparse-flow (KITTI/HD1K) variant: valid-mask-aware resampling."""

    def resize_sparse_flow_map(self, flow, valid, fx, fy):
        """Remap valid flow vectors by coordinates (≙ augmentor.py:160+),
        avoiding interpolation across invalid holes."""
        h, w = flow.shape[:2]
        nh, nw = int(round(h * fy)), int(round(w * fx))
        ys, xs = np.nonzero(valid)
        fl = flow[ys, xs] * np.array([fx, fy], np.float32)
        nx = np.round(xs * fx).astype(np.int64)
        ny = np.round(ys * fy).astype(np.int64)
        keep = (nx >= 0) & (nx < nw) & (ny >= 0) & (ny < nh)
        out_f = np.zeros((nh, nw, 2), np.float32)
        out_v = np.zeros((nh, nw), bool)
        out_f[ny[keep], nx[keep]] = fl[keep]
        out_v[ny[keep], nx[keep]] = True
        return out_f, out_v

    def __call__(self, img1, img2, flow, valid, rng=None):
        rng = rng or np.random.default_rng()
        img1, img2 = self.color_transform(
            img1.astype(np.float32), img2.astype(np.float32), rng
        )
        img1, img2 = self.eraser_transform(img1, img2, rng)

        ch, cw = self.crop_size
        h, w = img1.shape[:2]
        min_scale = np.maximum((ch + 1) / h, (cw + 1) / w)
        scale = max(2 ** rng.uniform(self.min_scale, self.max_scale),
                    min_scale)
        if rng.random() < self.spatial_prob:
            nh, nw = int(round(h * scale)), int(round(w * scale))
            img1 = _resize_bilinear_np(img1, (nh, nw))
            img2 = _resize_bilinear_np(img2, (nh, nw))
            flow, valid = self.resize_sparse_flow_map(flow, valid, scale,
                                                      scale)
        if self.do_flip and rng.random() < 0.5:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
            valid = valid[:, ::-1]

        h, w = img1.shape[:2]
        y0 = int(rng.integers(0, max(h - ch, 0) + 1))
        x0 = int(rng.integers(0, max(w - cw, 0) + 1))
        sl = np.s_[y0 : y0 + ch, x0 : x0 + cw]
        return (np.ascontiguousarray(img1[sl]),
                np.ascontiguousarray(img2[sl]),
                np.ascontiguousarray(flow[sl]),
                np.ascontiguousarray(valid[sl]))
