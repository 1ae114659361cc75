"""Flow / depth visualization.

The PyTorch port's copy of `deep_sfm_revisited_tpu/utils/viz.py` (the port
imports nothing of the JAX package). `depth_to_colormap` looks its colormap
up in a table of matplotlib's "bone" built here in numpy, so the port needs
no matplotlib; the colors are matplotlib's, entry for entry.

Rebuild of `flow_viz.py` (Middlebury color-wheel flow rendering,
`flow_viz.py:22-143` `make_colorwheel`/`flow_uv_to_colors`, entry
`:239-280`), the raw flow RGB of `flow2rgb_raw` (`main.py:777-789`), and
the depth colormap of `tensor2array` (`utils.py:165-192`). numpy host
code, used for logging images.
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """The 55-color Middlebury wheel (≙ `make_colorwheel`, flow_viz.py:22)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    ramps = [
        (RY, 0, 1, False),  # R->Y
        (YG, 1, 0, True),
        (GC, 1, 2, False),
        (CB, 2, 1, True),
        (BM, 2, 0, False),
        (MR, 0, 2, True),
    ]
    for n, c_full, c_ramp, down in ramps:
        wheel[col : col + n, c_full] = 255
        ramp = np.floor(255 * np.arange(n) / n)
        wheel[col : col + n, c_ramp] = 255 - ramp if down else ramp
        col += n
    return wheel


_WHEEL = make_colorwheel()


def flow_to_rgb(flow: np.ndarray, clip: float | None = None) -> np.ndarray:
    """Flow (H, W, 2) -> uint8 RGB (H, W, 3) via the Middlebury wheel
    (≙ `flow_to_image`/`flow_uv_to_colors`, flow_viz.py:66-143)."""
    flow = np.asarray(flow, np.float32)
    u, v = flow[..., 0], flow[..., 1]
    if clip is not None:
        u = np.clip(u, -clip, clip)
        v = np.clip(v, -clip, clip)
    rad = np.sqrt(u * u + v * v)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = rad / rad_max

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.floor(255 * col)
    return img


def flow_to_rgb_raw(flow: np.ndarray, max_value: float = 128.0) -> np.ndarray:
    """Simple (u, v, 0) normalization (≙ `flow2rgb_raw`, main.py:777-789)."""
    flow = np.asarray(flow, np.float32)
    rgb = np.zeros(flow.shape[:2] + (3,), np.float32)
    norm = flow / max_value
    rgb[..., 0] = np.clip(norm[..., 0], -1, 1) * 0.5 + 0.5
    rgb[..., 1] = np.clip(norm[..., 1], -1, 1) * 0.5 + 0.5
    return (rgb * 255).astype(np.uint8)


# matplotlib's "bone" (its `_bone_data`): per channel, (x, y) knots of a
# piecewise-linear map, sampled into a 256-entry table as matplotlib samples it
_BONE = {"red": ((0.0, 0.0), (0.746032, 0.652778), (1.0, 1.0)),
         "green": ((0.0, 0.0), (0.365079, 0.319444), (0.746032, 0.777778), (1.0, 1.0)),
         "blue": ((0.0, 0.0), (0.365079, 0.444444), (1.0, 1.0))}
_LUT_N = 256


def _lut(knots) -> np.ndarray:
    """Linear interpolation between the knots at 256 points, in matplotlib's
    own arithmetic (`colors._create_lookup_table`), so each entry matches it
    to the last bit and no uint8 color rounds the other way."""
    x, y = (np.asarray(v, np.float64) for v in zip(*knots))
    x = x * (_LUT_N - 1)
    xind = (_LUT_N - 1) * np.linspace(0, 1, _LUT_N)
    ind = np.searchsorted(x, xind)[1:-1]
    dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    return np.clip(np.concatenate([y[:1], dist * (y[ind] - y[ind - 1]) + y[ind - 1], y[-1:]]),
                   0.0, 1.0)


_COLORMAPS = {"bone": np.stack([_lut(_BONE[c]) for c in ("red", "green", "blue")], -1)}


def depth_to_colormap(
    depth: np.ndarray, max_value: float | None = 80.0, colormap: str = "bone"
) -> np.ndarray:
    """Depth (H, W) -> uint8 RGB via a colormap
    (≙ `tensor2array`, utils.py:165-192)."""
    depth = np.asarray(depth, np.float32)
    mv = max_value if max_value is not None else max(depth.max(), 1e-5)
    norm = np.clip(depth / mv, 0, 1)
    bad = np.isnan(norm)                      # matplotlib's "bad" color: black
    idx = np.minimum((np.where(bad, 0, norm) * _LUT_N).astype(np.int64), _LUT_N - 1)
    rgb = np.where(bad[..., None], 0.0, _COLORMAPS[colormap][idx])
    return (rgb * 255).astype(np.uint8)
