"""The port's data layer against the JAX package's: golden-tree writers, the
PNG decoder, and the KITTI datasets behind the batch loader, array for
array (all exact: the same numpy code on the same bytes)."""

import filecmp
import os
import struct
import zlib

import numpy as np
import pytest

from deep_sfm_revisited_tpu.data import BatchLoader as JLoader
from deep_sfm_revisited_tpu.data import kitti as jkitti
from deep_sfm_revisited_tpu.data import synthetic as jsyn
from deep_sfm_revisited_tpu.data import transforms as jtf
from deep_sfm_revisited_tpu_torch.data import BatchLoader as TLoader
from deep_sfm_revisited_tpu_torch.data import kitti as tkitti
from deep_sfm_revisited_tpu_torch.data import png
from deep_sfm_revisited_tpu_torch.data import synthetic as tsyn
from deep_sfm_revisited_tpu_torch.data import transforms as ttf

HW = (64, 96)


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_raw"))
    tsyn.write_kitti_raw_tree(root, n_frames=5, hw=HW, n_test=3)
    return root


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("writer", ["write_kitti_raw_tree", "write_kitti_vo_tree"])
def test_golden_writers_write_the_same_bytes(tmp_path, writer):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    getattr(jsyn, writer)(a, n_frames=3, hw=(32, 48))
    getattr(tsyn, writer)(b, n_frames=3, hw=(32, 48))
    assert _files(a) == _files(b)
    for f in _files(a):
        if f.endswith(".npy"):      # pickled dicts: compare the contents
            ja = np.load(os.path.join(a, f), allow_pickle=True).item()
            tb = np.load(os.path.join(b, f), allow_pickle=True).item()
            assert ja.keys() == tb.keys()
            for k in ja:
                np.testing.assert_array_equal(ja[k], tb[k])
        else:
            assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


def test_png_decoder_matches_the_jax_reader_on_the_tree(raw_tree):
    img_dir = os.path.join(raw_tree, "2011_09_26", "2011_09_26_drive_0001_sync",
                           "image_02", "data")
    gt_dir = os.path.join(raw_tree, "gt_depth", "2011_09_26_drive_0001_sync",
                          "proj_depth", "groundtruth", "image_02")
    for name in sorted(os.listdir(img_dir)):
        np.testing.assert_array_equal(tkitti._imread(os.path.join(img_dir, name)),
                                      jkitti._imread(os.path.join(img_dir, name)))
        np.testing.assert_array_equal(tkitti.load_depth_png(os.path.join(gt_dir, name)),
                                      jkitti.load_depth_png(os.path.join(gt_dir, name)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_filtered(img, depth, color):
    """A PNG whose scanlines cycle through filter types 0..4."""
    h = img.shape[0]
    rows = (img.astype(">u2") if depth == 16 else img).reshape(h, -1).view(np.uint8)
    rows = rows.astype(np.int64)
    bpp = (1 if img.ndim == 2 else img.shape[2]) * depth // 8
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        raw, kind = rows[y], y % 5
        a = np.concatenate([np.zeros(bpp, np.int64), raw[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = [0, a, prior, (a + prior) // 2, _paeth(a, prior, c)][kind]
        out.append(bytes([kind]) + ((raw - pred) % 256).astype(np.uint8).tobytes())
        prior = raw
    w = img.shape[1]

    def chunk(typ, data):
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "gray8", "gray16"])
def test_png_decoder_undoes_every_filter(tmp_path, kind):
    """Hand-filtered PNGs (filter types 0-4 by row): the port's decoder
    gives the pixels back exactly, and agrees with the JAX reader."""
    rng = np.random.RandomState(0)
    shape, depth, color = {"rgb8": ((11, 13, 3), 8, 2), "rgba8": ((10, 7, 4), 8, 6),
                           "gray8": ((9, 12), 8, 0), "gray16": ((12, 10), 16, 0)}[kind]
    img = rng.randint(0, 2 ** depth, shape).astype(np.uint16 if depth == 16 else np.uint8)
    path = str(tmp_path / f"{kind}.png")
    with open(path, "wb") as f:
        f.write(_encode_filtered(img, depth, color))
    np.testing.assert_array_equal(png.read_png(path), img)
    if kind == "gray16":
        np.testing.assert_array_equal(tkitti.load_depth_png(path), jkitti.load_depth_png(path))
    else:
        np.testing.assert_array_equal(tkitti._imread(path), jkitti._imread(path))


def test_png_decoder_refuses_what_it_cannot_read():
    with pytest.raises(ValueError):
        png.decode_png(b"GIF89a")


def _batches(loader):
    return [dict(b) for b in loader]


def _assert_same_batches(jb, tb):
    assert len(jb) == len(tb) > 0
    for j, t in zip(jb, tb):
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_eval_batches_equal_jax(raw_tree):
    """The eval split through Normalize + BatchLoader padded to /64."""
    gt = os.path.join(raw_tree, "gt_depth")

    def run(kit, tf, Loader):
        ds = kit.KittiRawDataset(raw_tree, train=False, gt_depth_dir=gt,
                                 transform=tf.Compose([tf.Normalize()]))
        return _batches(Loader(ds, 1, shuffle=False, workers=2, pad_multiple=64,
                               drop_last=False))

    jb, tb = run(jkitti, jtf, JLoader), run(tkitti, ttf, TLoader)
    assert tb[0]["ref"].shape == (1, 64, 128, 3) and tb[0]["raw_hw"].tolist() == [list(HW)]
    _assert_same_batches(jb, tb)


def test_train_batches_equal_jax(raw_tree):
    """The train split with the random transforms, one worker, same seed."""
    def run(kit, tf, Loader):
        ds = kit.KittiRawDataset(raw_tree, train=True, transform=tf.Compose(
            [tf.RandomZoom(), tf.RandomCrop((48, 64)), tf.RandomHorizontalFlip(),
             tf.ColorJitter(), tf.Normalize()]))
        return _batches(Loader(ds, 2, workers=1, pad_multiple=16, seed=3))

    _assert_same_batches(run(jkitti, jtf, JLoader), run(tkitti, ttf, TLoader))


def test_vo_batches_equal_jax(tmp_path):
    root = str(tmp_path / "vo")
    tsyn.write_kitti_vo_tree(root, n_frames=3, hw=(32, 48))

    def run(kit, tf, Loader):
        ds = kit.KittiVODataset(root, train=False, transform=tf.Compose([tf.Normalize()]))
        return _batches(Loader(ds, 1, shuffle=False, workers=1, pad_multiple=32,
                               drop_last=False))

    _assert_same_batches(run(jkitti, jtf, JLoader), run(tkitti, ttf, TLoader))
