"""Paired (images, depths, intrinsics) transforms, host-side numpy.

The PyTorch port's verbatim copy of `deep_sfm_revisited_tpu/data/transforms.py`
(the port imports nothing of the JAX package).

Rebuild of `flow_transforms.py` (`ComposeCo` `:18`, `NormalizeCo` `:29`,
`ArrayToTensorCo` `:41`, `CenterCropCo` `:56`, `RandomCropCo` `:77`,
random zoom `:89-98`, sparse-depth-aware resize `:115-147`): every
geometric op acts jointly on both images, both depth maps, and the
intrinsics (cx/cy shift on crop, focal rescale on zoom). Depth maps are
sparse (zeros = missing), so zoom uses nearest-neighbor resampling to
avoid bleeding valid depths into holes.

Layout: images (H, W, 3) float32; depths (H, W) float32; K (3, 3).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, images, depths, K, rng=None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            images, depths, K = t(images, depths, K, rng)
        return images, depths, K


class Normalize:
    """uint8 [0,255] -> [-1, 1] float (the reference normalizes with
    mean=.5/std=.5 after /255, `main.py:161-166`)."""

    def __call__(self, images, depths, K, rng):
        images = [(im.astype(np.float32) / 255.0 - 0.5) / 0.5 for im in images]
        return images, depths, K


class CenterCrop:
    def __init__(self, size: Tuple[int, int]):
        self.h, self.w = size

    def __call__(self, images, depths, K, rng):
        H, W = images[0].shape[:2]
        y = max((H - self.h) // 2, 0)
        x = max((W - self.w) // 2, 0)
        return _crop(images, depths, K, y, x, self.h, self.w)


class RandomCrop:
    def __init__(self, size: Tuple[int, int]):
        self.h, self.w = size

    def __call__(self, images, depths, K, rng):
        H, W = images[0].shape[:2]
        y = int(rng.integers(0, max(H - self.h, 0) + 1))
        x = int(rng.integers(0, max(W - self.w, 0) + 1))
        return _crop(images, depths, K, y, x, self.h, self.w)


def _crop(images, depths, K, y, x, h, w):
    images = [im[y : y + h, x : x + w] for im in images]
    depths = [d[y : y + h, x : x + w] if d is not None else None for d in depths]
    K = K.copy()
    K[0, 2] -= x  # cx/cy shift (flow_transforms.py:73-74,109-110)
    K[1, 2] -= y
    return images, depths, K


class RandomZoom:
    """Random up-zoom 1.0-1.15 with intrinsics rescale
    (≙ `flow_transforms.py:89-98`, cfg.ZOOM_INPUT)."""

    def __init__(self, max_zoom: float = 1.15):
        self.max_zoom = max_zoom

    def __call__(self, images, depths, K, rng):
        s = float(rng.uniform(1.0, self.max_zoom))
        if s == 1.0:
            return images, depths, K
        H, W = images[0].shape[:2]
        h, w = int(round(H * s)), int(round(W * s))
        images = [_resize_bilinear_np(im, (h, w)) for im in images]
        # nearest for sparse depth (flow_transforms.py:115-147); values are
        # metric so no magnitude rescale
        depths = [
            _resize_nearest_np(d, (h, w)) if d is not None else None
            for d in depths
        ]
        K = K.copy()
        K[0] *= w / W
        K[1] *= h / H
        return images, depths, K


class RandomHorizontalFlip:
    """Joint left-right flip (≙ FLIP_AUG, KITTI_loader.py:392-396)."""

    def __init__(self, prob: float = 0.25):
        self.prob = prob

    def __call__(self, images, depths, K, rng):
        if rng.random() > self.prob:
            return images, depths, K
        W = images[0].shape[1]
        images = [np.ascontiguousarray(im[:, ::-1]) for im in images]
        depths = [
            np.ascontiguousarray(d[:, ::-1]) if d is not None else None
            for d in depths
        ]
        K = K.copy()
        K[0, 2] = W - 1 - K[0, 2]
        return images, depths, K


class ColorJitter:
    """Brightness/contrast/saturation jitter on uint8-range images
    (≙ torchvision ColorJitter use, KITTI_loader.py:115,248-254)."""

    def __init__(self, strength: float = 0.2, prob: float = 0.5):
        self.s = strength
        self.prob = prob

    def __call__(self, images, depths, K, rng):
        if rng.random() > self.prob:
            return images, depths, K
        b = float(rng.uniform(1 - self.s, 1 + self.s))
        c = float(rng.uniform(1 - self.s, 1 + self.s))
        out = []
        for im in images:
            x = im.astype(np.float32) * b
            mean = x.mean(axis=(0, 1), keepdims=True)
            x = (x - mean) * c + mean
            out.append(np.clip(x, 0, 255))
        return out, depths, K


def _resize_bilinear_np(im: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    h, w = hw
    H, W = im.shape[:2]
    ys = np.linspace(0, H - 1, h, dtype=np.float32)
    xs = np.linspace(0, W - 1, w, dtype=np.float32)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    im = im.astype(np.float32)
    if im.ndim == 2:
        im = im[..., None]
        squeeze = True
    else:
        squeeze = False
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out[..., 0] if squeeze else out


def _resize_nearest_np(im: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    h, w = hw
    H, W = im.shape[:2]
    ys = np.clip(np.round(np.linspace(0, H - 1, h)).astype(np.int64), 0, H - 1)
    xs = np.clip(np.round(np.linspace(0, W - 1, w)).astype(np.int64), 0, W - 1)
    return im[ys][:, xs]
