"""PNG decoder, size probe and uint16 writers on zlib + numpy (no image library).

The port reads KITTI's frames (8-bit RGB), its depth maps (16-bit gray,
depth * 256) and its flow maps (16-bit RGB: u, v, valid) with this module,
probes a frame's size from its header (`probe_png`, for the VO depth
exporter) and writes 16-bit gray depth maps (`write_png_u16`) and 16-bit RGB
flow maps (`write_png_rgb16`): the JAX package's readers and writers go
through a C++ libpng library, imageio or cv2, none of which the port may
assume.

Decodes non-interlaced PNGs of bit depth 8 (gray, gray + alpha, RGB, RGBA)
or 16 (gray, RGB, RGBA), with all five scanline filters. Sub and Up are
vectorized; Average and Paeth depend on the byte to their left, so they run
as a byte loop per row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # color type -> samples per pixel


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG stream")
    off = 8
    while off + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, off)
        kind = data[off + 4:off + 8]
        yield kind, data[off + 8:off + 8 + length]
        off += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG stream ends before IEND")


def _average(row: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(row)):
        left = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF


def _paeth(row: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(row)):
        if i >= bpp:
            a, c = row[i - bpp], prior[i - bpp]
        else:
            a = c = 0
        b = prior[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters -> (h, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG image data is {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    kinds, filt = rows[:, 0], rows[:, 1:]
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, f = int(kinds[y]), filt[y]
        if kind == 0:
            out[y] = f
        elif kind == 1:   # Sub: running sum mod 256 along each byte lane
            out[y] = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:   # Up
            out[y] = f + prior
        elif kind in (3, 4):
            row = bytearray(f.tobytes())
            (_average if kind == 3 else _paeth)(row, prior.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind}")
        prior = out[y]
    return out


def probe_png(data: bytes):
    """(h, w, channels, bit_depth) from a PNG stream's IHDR without
    decoding it, or None when the stream does not start with one."""
    if data[:8] != _SIGNATURE or data[12:16] != b"IHDR" or len(data) < 26:
        return None
    w, h, depth, color = struct.unpack_from(">IIBB", data, 16)
    if color not in _CHANNELS:
        return None
    return h, w, _CHANNELS[color], depth


def _encode(arr: np.ndarray, color: int) -> bytes:
    """(h, w[, c]) uint16 samples -> a 16-bit PNG stream of `color` type: one
    zlib-compressed IDAT of filter-type-0 scanlines, samples big-endian as
    the format stores them."""
    arr = np.ascontiguousarray(arr).astype(">u2")
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 16, color, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def encode_png_u16(img: np.ndarray) -> bytes:
    """(h, w) uint16 -> a 16-bit gray PNG stream."""
    if img.dtype != np.uint16 or img.ndim != 2:
        raise TypeError(f"encode_png_u16 wants a 2-D uint16 array, got {img.dtype} {img.shape}")
    return _encode(img, 0)


def encode_png_rgb16(img: np.ndarray) -> bytes:
    """(h, w, 3) uint16 -> a 16-bit RGB PNG stream, channels in R, G, B order
    (KITTI's flow maps: u, v, valid)."""
    if img.dtype != np.uint16 or img.ndim != 3 or img.shape[2] != 3:
        raise TypeError(f"encode_png_rgb16 wants an (h, w, 3) uint16 array, got {img.dtype} "
                        f"{img.shape}")
    return _encode(img, 2)


def write_png_u16(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png_u16(img))


def write_png_rgb16(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png_rgb16(img))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (h, w) for gray, else (h, w, channels); uint8 at bit
    depth 8, uint16 (native byte order) at 16."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG stream has no IHDR")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or (depth == 16 and color == 4):
        raise ValueError(f"PNG color type {color} at bit depth {depth} is not supported")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    img = px.view(">u2").astype(np.uint16) if depth == 16 else px
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
