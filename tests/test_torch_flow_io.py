"""The port's flow file I/O (`data/flow_io.py`) against the JAX package's.

KITTI's 16-bit flow PNGs, Middlebury .flo and .pfm, each written by one
package and read by the other, on arrays made with numpy from a seed. The
JAX package reads and writes KITTI PNGs through cv2 in B, G, R order; the
port through `data/png.py` in R, G, B order, so a map must survive both
ways with u, v and the valid mask in their places. Also the 16-bit RGB
encoder against PIL's decoder (which keeps each sample's high byte) and
cv2's (all 16 bits). Everything is exact: the files hold integers, or the
same float32 bits.
"""

import io

import numpy as np
import pytest
from PIL import Image

from deep_sfm_revisited_tpu.data import flow_io as jio
from deep_sfm_revisited_tpu_torch.data import flow_io as tio
from deep_sfm_revisited_tpu_torch.data import png

H, W = 23, 37


def _flow(seed, invalid=True):
    rng = np.random.default_rng(seed)
    flow = rng.uniform(-300, 300, (H, W, 2)).astype(np.float32)
    flow[0, 0] = (600.0, -600.0)          # clipped to the 16-bit range
    valid = rng.random((H, W)) < 0.6 if invalid else np.ones((H, W), bool)
    return flow, valid


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_kitti_flow_png_both_ways(tmp_path, writer):
    flow, valid = _flow(1)
    path = str(tmp_path / "000000_10.png")
    (jio if writer == "jax" else tio).write_flow_kitti(path, flow, valid)
    jf, jv = jio.read_flow_kitti(path)
    tf, tv = tio.read_flow_kitti(path)
    assert tf.dtype == np.float32 and tv.dtype == bool
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tv, valid)
    np.testing.assert_array_equal(tf, jf)
    # 1/64 px quantization inside the range, zero where not valid
    inside = valid & (np.abs(flow) < 500).all(-1)
    assert np.abs(tf[inside] - flow[inside]).max() <= 1 / 64
    assert not tf[~valid].any()


def test_kitti_flow_png_files_are_equal(tmp_path):
    """Both writers put the same samples in the file (all valid by default)."""
    flow, _ = _flow(2, invalid=False)
    jio.write_flow_kitti(str(tmp_path / "j.png"), flow)
    tio.write_flow_kitti(str(tmp_path / "t.png"), flow)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "t.png")),
                                  png.read_png(str(tmp_path / "j.png")))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_flo_both_ways(tmp_path, writer):
    flow, _ = _flow(3)
    path = str(tmp_path / "frame_0001.flo")
    (jio if writer == "jax" else tio).write_flo(path, flow)
    np.testing.assert_array_equal(tio.read_flo(path), jio.read_flo(path))
    np.testing.assert_array_equal(tio.read_gen(path), flow)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("channels", [0, 3])
def test_pfm_both_ways(tmp_path, writer, channels):
    rng = np.random.default_rng(4)
    data = rng.standard_normal((H, W, channels) if channels else (H, W)).astype(np.float32)
    path = str(tmp_path / "0006.pfm")
    (jio if writer == "jax" else tio).write_pfm(path, data, scale=2.0)
    (td, ts), (jd, js) = tio.read_pfm(path), jio.read_pfm(path)
    assert ts == js == 2.0
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(td, data)
    np.testing.assert_array_equal(tio.read_gen(path), data)


def test_disparity_and_generic_png(tmp_path):
    disp = np.random.default_rng(5).integers(0, 2**16, (H, W), dtype=np.uint16)
    path = str(tmp_path / "disp.png")
    png.write_png_u16(path, disp)
    np.testing.assert_array_equal(tio.read_disp_kitti(path), jio.read_disp_kitti(path))
    rgb = np.random.default_rng(6).integers(0, 256, (H, W, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(str(tmp_path / "img.png"))
    Image.fromarray(rgb).save(str(tmp_path / "img.ppm"))
    for name in ("img.png", "img.ppm"):
        got = tio.read_gen(str(tmp_path / name))
        np.testing.assert_array_equal(got, jio.read_gen(str(tmp_path / name)))
        np.testing.assert_array_equal(got, rgb)


def test_rgb16_encoder_round_trip():
    """The 16-bit RGB encoder's stream: the port's decoder and cv2 read every
    bit back in R, G, B order (cv2 as B, G, R); PIL, which holds RGB at 8
    bits, reads each sample's high byte."""
    import cv2

    img = np.random.default_rng(7).integers(0, 2**16, (H, W, 3), dtype=np.uint16)
    data = png.encode_png_rgb16(img)
    np.testing.assert_array_equal(png.decode_png(data), img)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), -1)[..., ::-1],
                                  img)
    pil = Image.open(io.BytesIO(data))
    assert pil.size == (W, H)
    np.testing.assert_array_equal(np.asarray(pil.convert("RGB")), (img >> 8).astype(np.uint8))
    with pytest.raises(TypeError):
        png.encode_png_rgb16(img[..., 0])
    with pytest.raises(TypeError):
        png.encode_png_rgb16(img.astype(np.uint8))
