"""Minimal TensorBoard event-file writer (no tensorboard dependency).

The PyTorch port's verbatim copy of `deep_sfm_revisited_tpu/utils/tb_events.py`
(the port imports nothing of the JAX package).

The reference logs scalars through tensorboardX
(`main.py:147-148,390-450`); this writes the same on-disk artifact — a
`events.out.tfevents.*` file TensorBoard can load directly — from
first principles: hand-encoded protobuf `Event{wall_time, step,
Summary{Value{tag, simple_value}}}` messages in the TFRecord framing
(length + masked-crc32c(length) + payload + masked-crc32c(payload)).

Scalar and image summaries are supported — everything the reference
emits (scalars `main.py:390-427`; input / flow-RGB / depth-colormap
image panes every print period `main.py:429-447`). Images are encoded
as PNG by a from-scratch zlib-based encoder (no imageio dependency in
this module).
Format references: tensorflow/core/util/event.proto +
tensorflow/core/framework/summary.proto +
tensorflow/core/lib/hash/crc32c (public wire formats).
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional

# --- crc32c (Castagnoli), table-driven ------------------------------------

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reflected Castagnoli polynomial
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord CRC masking: rotate right 15 and add a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf wire encoding ---------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _f_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _f_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _f_varint(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _summary_value(tag: str, value: float) -> bytes:
    # Summary.Value{ string tag = 1; float simple_value = 2; }
    return _f_bytes(1, tag.encode()) + _f_float(2, value)


def encode_png(img) -> bytes:
    """Minimal PNG encoder (8-bit gray / gray+alpha / RGB / RGBA).

    One zlib-compressed IDAT with filter-type-0 scanlines — the simplest
    spec-conformant stream; TensorBoard (and any PNG reader) loads it.
    """
    import zlib

    import numpy as np

    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png wants uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _summary_image_value(tag: str, png: bytes, h: int, w: int,
                         colorspace: int) -> bytes:
    # Summary.Value{ tag = 1; Summary.Image image = 4 }
    # Summary.Image{ int32 height = 1; int32 width = 2;
    #                int32 colorspace = 3; bytes encoded_image_string = 4 }
    image = (_f_varint(1, h) + _f_varint(2, w) + _f_varint(3, colorspace)
             + _f_bytes(4, png))
    return _f_bytes(1, tag.encode()) + _f_bytes(4, image)


def encode_image_event(tag: str, img, step: int,
                       wall_time: Optional[float] = None) -> bytes:
    """Event carrying one PNG image summary. `img`: uint8 (H, W[, C])."""
    import numpy as np

    wt = time.time() if wall_time is None else wall_time
    arr = np.ascontiguousarray(img)
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    summary = _f_bytes(
        1, _summary_image_value(tag, encode_png(arr), h, w, c))
    return _f_double(1, wt) + _f_varint(2, step) + _f_bytes(5, summary)


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: Optional[float] = None) -> bytes:
    """Event{ double wall_time=1; int64 step=2; Summary summary=5 }."""
    wt = time.time() if wall_time is None else wall_time
    summary = _f_bytes(1, _summary_value(tag, value))  # Summary.value[0]
    return _f_double(1, wt) + _f_varint(2, step) + _f_bytes(5, summary)


def encode_file_version_event(wall_time: Optional[float] = None) -> bytes:
    """The conventional first record: Event{ file_version = 3 }."""
    wt = time.time() if wall_time is None else wall_time
    return _f_double(1, wt) + _f_bytes(3, b"brain.Event:2")


def tfrecord_frame(payload: bytes) -> bytes:
    """length(u64) + masked_crc(length) + payload + masked_crc(payload)."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header))
            + payload + struct.pack("<I", masked_crc32c(payload)))


class TBEventWriter:
    """Append scalar events to an `events.out.tfevents.*` file."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.dsfm"
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._f.write(tfrecord_frame(encode_file_version_event()))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(
            tfrecord_frame(encode_scalar_event(tag, float(value),
                                               int(step)))
        )

    def add_image(self, tag: str, img, step: int):
        """img: uint8 (H, W) / (H, W, C) array (C in {1, 2, 3, 4})."""
        self._f.write(tfrecord_frame(encode_image_event(tag, img,
                                                        int(step))))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


# --- reader (for tests / offline inspection) ------------------------------


def read_events(path: str):
    """Parse a tfevents file back into dicts. Verifies CRCs.

    Decodes only the fields this module writes (wall_time, step,
    file_version, scalar summaries) — enough for round-trip tests and
    quick shell inspection without TensorBoard.
    """
    out = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (ln,) = struct.unpack_from("<Q", data, off)
        (lcrc,) = struct.unpack_from("<I", data, off + 8)
        assert masked_crc32c(data[off:off + 8]) == lcrc, "bad length crc"
        payload = data[off + 12: off + 12 + ln]
        (pcrc,) = struct.unpack_from("<I", data, off + 12 + ln)
        assert masked_crc32c(payload) == pcrc, "bad payload crc"
        out.append(_decode_event(payload))
        off += 12 + ln + 4
    return out


def _read_varint(buf: bytes, off: int):
    n = shift = 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, off
    raise AssertionError


def _decode_event(buf: bytes):
    ev = {}
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        num, wire = key >> 3, key & 7
        if wire == 1:
            (v,) = struct.unpack_from("<d", buf, off)
            off += 8
            if num == 1:
                ev["wall_time"] = v
        elif wire == 0:
            v, off = _read_varint(buf, off)
            if num == 2:
                ev["step"] = v
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            sub = buf[off:off + ln]
            off += ln
            if num == 3:
                ev["file_version"] = sub.decode()
            elif num == 5:
                ev.update(_decode_summary(sub))
        elif wire == 5:
            off += 4
        else:  # pragma: no cover - we never write other wires
            raise AssertionError(f"wire {wire}")
    return ev


def _decode_summary(buf: bytes):
    off = 0
    tag, val, image = None, None, None
    while off < len(buf):
        key, off = _read_varint(buf, off)
        num, wire = key >> 3, key & 7
        assert wire == 2 and num == 1
        ln, off = _read_varint(buf, off)
        sub = buf[off:off + ln]
        off += ln
        soff = 0
        while soff < len(sub):
            skey, soff = _read_varint(sub, soff)
            snum, swire = skey >> 3, skey & 7
            if swire == 2:
                sln, soff = _read_varint(sub, soff)
                if snum == 1:
                    tag = sub[soff:soff + sln].decode()
                elif snum == 4:
                    image = _decode_image(sub[soff:soff + sln])
                soff += sln
            elif swire == 5:
                if snum == 2:
                    (val,) = struct.unpack_from("<f", sub, soff)
                soff += 4
            else:  # pragma: no cover
                raise AssertionError
    out = {"tag": tag, "value": val}
    if image is not None:
        out["image"] = image
    return out


def _decode_image(buf: bytes):
    """Summary.Image -> {height, width, colorspace, png(bytes)}."""
    off = 0
    img = {}
    while off < len(buf):
        key, off = _read_varint(buf, off)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, off = _read_varint(buf, off)
            img[{1: "height", 2: "width", 3: "colorspace"}[num]] = v
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            if num == 4:
                img["png"] = buf[off:off + ln]
            off += ln
        else:  # pragma: no cover
            raise AssertionError
    return img
