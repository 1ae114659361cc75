"""The port's VO depth exporter (`data/velodyne.py`) against the JAX package's.

A scan, an odometry calib.txt (P2 and Tr) and a camera frame written by the
test; both exporters project the scan into a uint16 depth*256 PNG under
RealDepth/<seq>/velodyne/. The JAX exporter writes with imageio; the port
with `data/png.py`. Both PNGs decode (with imageio and with the port's
decoder) to the same array, exactly. The port's PNG size probe and uint16
writer are checked against imageio on their own.
"""

import os

import imageio.v2 as imageio
import numpy as np
import pytest

from deep_sfm_revisited_tpu.data import velodyne as jvel
from deep_sfm_revisited_tpu_torch.data import png as tpng
from deep_sfm_revisited_tpu_torch.data import velodyne as tvel
from deep_sfm_revisited_tpu_torch.utils.tb_events import encode_png

H, W = 37, 121


def _calib(path):
    P2 = np.array([[700.0, 0, 60.5, 44.8], [0, 700.0, 18.2, 0.2], [0, 0, 1, 0.003]])
    Tr = np.array([[0, -1, 0, 0.01], [0, 0, -1, -0.08], [1, 0, 0, -0.27]], np.float64)
    with open(path, "w") as f:
        for name, m in (("P0", P2), ("P2", P2), ("Tr", Tr)):
            f.write(f"{name}: " + " ".join(f"{v:.12e}" for v in m.ravel()) + "\n")


def _scan(path, n, seed):
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-5, 80, n), rng.uniform(-10, 10, n),
                    rng.uniform(-2, 2, n), rng.uniform(0, 1, n)], -1).astype(np.float32)
    pts.tofile(path)


@pytest.fixture()
def tree(tmp_path):
    roots = []
    for side in ("jax", "torch"):
        root = tmp_path / side
        seq = root / "sequences" / "04"
        (seq / "velodyne").mkdir(parents=True)
        (seq / "image_2").mkdir()
        _calib(seq / "calib.txt")
        for i in range(3):
            _scan(seq / "velodyne" / f"{i:06d}.bin", 4000, i)
            if i < 2:   # the last scan has no camera frame and is skipped
                img = np.random.RandomState(i).randint(0, 255, (H, W, 3), np.uint8)
                (seq / "image_2" / f"{i:06d}.png").write_bytes(encode_png(img))
        roots.append(str(root))
    return roots


def test_exporter_matches_jax(tree):
    jroot, troot = tree
    assert jvel.export_sequence(jroot, "04") == 2
    assert tvel.export_sequence(troot, "04") == 2
    for i in range(2):
        name = os.path.join("RealDepth", "04", "velodyne", f"{i:06d}.png")
        want = imageio.imread(os.path.join(jroot, name))
        got = imageio.imread(os.path.join(troot, name))
        assert got.dtype == np.uint16 and got.shape == (H, W) and (got > 0).sum() > 50
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tpng.read_png(os.path.join(troot, name)), want)
    assert not os.path.exists(os.path.join(troot, "RealDepth", "04", "velodyne", "000002.png"))


def test_projection_and_calib_match_jax(tree):
    _, root = tree
    calib = os.path.join(root, "sequences", "04", "calib.txt")
    for a, b in zip(tvel.odometry_calib(calib), jvel.odometry_calib(calib)):
        np.testing.assert_array_equal(a, b)
    P2, Tr = tvel.odometry_calib(calib)
    pts = tvel.load_velodyne_points(os.path.join(root, "sequences", "04", "velodyne",
                                                 "000001.bin"))
    np.testing.assert_array_equal(tvel.export_depth_png(pts, P2 @ Tr, (H, W)),
                                  jvel.export_depth_png(pts, P2 @ Tr, (H, W)))


def test_main_runs_the_listed_sequences(tree, capsys):
    _, root = tree
    tvel._main(["--root", root, "--seqs", "04"])
    assert "done: 2 files" in capsys.readouterr().out


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (64, 97)])
def test_png_u16_writer_and_probe(tmp_path, shape):
    img = np.random.RandomState(shape[1]).randint(0, 65536, shape).astype(np.uint16)
    path = str(tmp_path / "d.png")
    tpng.write_png_u16(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(tpng.read_png(path), img)
    with open(path, "rb") as f:
        assert tpng.probe_png(f.read()) == (shape[0], shape[1], 1, 16)
    rgb = str(tmp_path / "c.png")
    imageio.imwrite(rgb, np.zeros(shape + (3,), np.uint8))
    with open(rgb, "rb") as f:
        assert tpng.probe_png(f.read(64)) == (shape[0], shape[1], 3, 8)
    assert tpng.probe_png(b"not a png") is None
    with pytest.raises(TypeError):
        tpng.encode_png_u16(img.astype(np.int32))
