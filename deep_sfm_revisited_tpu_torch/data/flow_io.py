"""Optical-flow file I/O: .flo, .pfm, KITTI 16-bit PNG (port of
`deep_sfm_revisited_tpu/data/flow_io.py`).

The reference's `frame_utils.py` readers and writers (readFlow/writeFlow,
readPFM/writePFM, readFlowKITTI/writeFlowKITTI, readDispKITTI) and
`load_flow_from_png` (`KITTI_loader.py:20-30`). The JAX package reads and
writes KITTI's PNGs with cv2 (channels in B, G, R order) and imageio; the
port goes through `data/png.py`, which keeps R, G, B order, so a KITTI flow
map is u = channel 0, v = channel 1, valid = channel 2. Other image formats
are read by PIL.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

from deep_sfm_revisited_tpu_torch.data.png import read_png, write_png_rgb16

_FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if magic != _FLO_MAGIC:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, 2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([_FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    """PFM -> (data, scale); grayscale (H, W) or color (H, W, 3)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)), abs(scale)


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0) -> None:
    data = np.flipud(np.asarray(data, np.float32))
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())   # a negative scale: little-endian
        data.tofile(f)


def read_flow_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit PNG flow -> (flow (H, W, 2) float32, valid (H, W) bool).

    KITTI stores RGB16 = (u, v, valid) with (u, v) = (raw - 2^15) / 64;
    flow is zero where not valid (`load_flow_from_png`)."""
    raw = read_png(path).astype(np.float64)        # RGB16: (u, v, valid)
    flow = (raw[..., :2] - 2**15) / 64.0
    valid = raw[..., 2] > 0
    flow[~valid] = 0.0
    return flow.astype(np.float32), valid


def write_flow_kitti(path: str, flow: np.ndarray, valid: Optional[np.ndarray] = None) -> None:
    """(H, W, 2) flow [and (H, W) valid, all valid when None] -> a KITTI
    16-bit RGB PNG, u and v as round-toward-zero of flow 64 + 2^15, clipped
    to 16 bits."""
    h, w = flow.shape[:2]
    out = np.zeros((h, w, 3), np.uint16)           # RGB: (u, v, valid)
    enc = np.clip(flow * 64.0 + 2**15, 0, 2**16 - 1).astype(np.uint16)
    out[..., 0] = enc[..., 0]
    out[..., 1] = enc[..., 1]
    out[..., 2] = 1 if valid is None else valid.astype(np.uint16)
    write_png_rgb16(path, out)


def read_disp_kitti(path: str) -> np.ndarray:
    """KITTI uint16 / 256 disparity PNG."""
    return read_png(path).astype(np.float32) / 256.0


def read_gen(path: str):
    """Reader by extension (the reference's `frame_utils.read_gen`): .flo,
    .pfm (its data), .png (`data/png.py`), and anything else (FlyingChairs'
    .ppm frames) through PIL."""
    if path.endswith(".flo"):
        return read_flo(path)
    if path.endswith(".pfm"):
        return read_pfm(path)[0]
    if path.endswith(".png"):
        return read_png(path)
    from PIL import Image

    return np.asarray(Image.open(path))
