"""The port's flow data layer against the JAX package's: the two augmentors
(`data/flow_augment.py`), every flow dataset class (`data/flow_datasets.py`)
on small synthetic trees in each benchmark's layout, and collation through
`BatchLoader`.

The augmentors are pure numpy: the same `np.random.Generator` state must
give the same samples bit for bit, dense (FlyingChairs / Things / Sintel)
and sparse (KITTI / HD1K, valid-mask remapping). Each dataset item, with and
without augmentation, must equal JAX's bit for bit (images read through
`data/png.py` or PIL where JAX uses imageio, KITTI flow maps in R, G, B
order where JAX's cv2 reads B, G, R). Batches of both loaders, one worker
each, seeded alike, must be equal: images padded to /128, flow GT not
padded, as the JAX loader does. And the flow evaluation
(`train/flow_eval.py`: EPE, Fl-all, the Sintel and KITTI submission files)
against JAX's on the same datasets and forward, EPE and Fl-all to 1e-6
relative (the same float32 arithmetic in numpy), the files equal.
"""

import os

import numpy as np
import pytest
from PIL import Image

from deep_sfm_revisited_tpu.data import flow_augment as jaug
from deep_sfm_revisited_tpu.data import flow_datasets as jds
from deep_sfm_revisited_tpu.data import flow_io as jio
from deep_sfm_revisited_tpu.data.loader import BatchLoader as JLoader
from deep_sfm_revisited_tpu_torch.data import flow_augment as taug
from deep_sfm_revisited_tpu_torch.data import flow_datasets as tds
from deep_sfm_revisited_tpu_torch.data.loader import BatchLoader as TLoader

H, W = 48, 64
CROP = (32, 40)


def _img(rng):
    return rng.integers(0, 256, (H, W, 3), dtype=np.uint8)


def _write_img(path, rng):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(_img(rng)).save(path)


def _write_kitti_flow(path, rng):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    flow = rng.uniform(-20, 20, (H, W, 2)).astype(np.float32)
    jio.write_flow_kitti(path, flow, rng.random((H, W)) < 0.4)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One small tree per benchmark layout, written with PIL and the JAX
    package's writers."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("flow_trees")
    chairs = root / "chairs"
    for i in range(3):
        for k in (1, 2):
            p = str(chairs / "data" / f"{i + 1:05d}_img{k}.ppm")
            _write_img(p, rng)
        jio.write_flo(str(chairs / "data" / f"{i + 1:05d}_flow.flo"),
                      rng.uniform(-10, 10, (H, W, 2)).astype(np.float32))
    np.savetxt(str(chairs / "chairs_split.txt"), np.array([1, 2, 1]), fmt="%d")
    things = root / "things"
    for scene in ("A/0000", "A/0001"):
        for i in range(3):
            _write_img(str(things / "frames_cleanpass" / "TRAIN" / scene / "left" / f"{i:04d}.png"),
                       rng)
            for d in ("into_future", "into_past"):
                fdir = things / "optical_flow" / "TRAIN" / scene / d / "left"
                os.makedirs(fdir, exist_ok=True)
                jio.write_pfm(str(fdir / f"{i:04d}.pfm"),
                              rng.uniform(-10, 10, (H, W, 3)).astype(np.float32))
    sintel = root / "sintel"
    for scene in ("alley_1", "bamboo_1"):
        for i in range(3):
            _write_img(str(sintel / "training" / "clean" / scene / f"frame_{i + 1:04d}.png"), rng)
        for i in range(2):
            os.makedirs(sintel / "training" / "flow" / scene, exist_ok=True)
            flow = rng.uniform(-10, 10, (H, W, 2)).astype(np.float32)
            flow[0, :3] = 2000.0                 # beyond the dense validity gate
            jio.write_flo(str(sintel / "training" / "flow" / scene / f"frame_{i + 1:04d}.flo"),
                          flow)
    kitti = root / "kitti"
    for i in range(3):
        for suff in ("10", "11"):
            _write_img(str(kitti / "training" / "image_2" / f"{i:06d}_{suff}.png"), rng)
        _write_kitti_flow(str(kitti / "training" / "flow_occ" / f"{i:06d}_10.png"), rng)
    hd1k = root / "hd1k"
    for seq in range(2):
        for i in range(3):
            _write_img(str(hd1k / "hd1k_input" / "image_2" / f"{seq:06d}_{i:04d}.png"), rng)
            _write_kitti_flow(str(hd1k / "hd1k_flow_gt" / "flow_occ" / f"{seq:06d}_{i:04d}.png"),
                              rng)
    return {k: str(root / k) for k in ("chairs", "things", "sintel", "kitti", "hd1k")}


def _build(mod, name, root, augment):
    kw = {"augment": augment}
    if augment:
        kw["crop_size"] = CROP
    return {"chairs": mod.FlyingChairs, "things": mod.FlyingThings3D, "sintel": mod.MpiSintel,
            "kitti": mod.KITTIFlow, "hd1k": mod.HD1K}[name](root, **kw)


def _assert_items_equal(t, j, what):
    assert set(t) == set(j), what
    for k in j:
        assert t[k].dtype == j[k].dtype, f"{what} {k}"
        np.testing.assert_array_equal(t[k], j[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("seed", range(4))
def test_dense_augmentor_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    img1, img2 = _img(rng), _img(rng)
    flow = rng.uniform(-10, 10, (H, W, 2)).astype(np.float32)
    kw = dict(min_scale=-0.2, max_scale=0.5, eraser_prob=1.0, asymmetric_color_prob=0.5)
    j = jaug.FlowAugmentor(CROP, **kw)(img1, img2, flow, np.random.default_rng(seed))
    t = taug.FlowAugmentor(CROP, **kw)(img1, img2, flow, np.random.default_rng(seed))
    assert t[0].shape == (*CROP, 3) and t[2].shape == (*CROP, 2)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_sparse_augmentor_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    img1, img2 = _img(rng), _img(rng)
    flow = rng.uniform(-10, 10, (H, W, 2)).astype(np.float32)
    valid = rng.random((H, W)) < 0.3
    j = jaug.SparseFlowAugmentor(CROP, -0.2, 0.4)(img1, img2, flow, valid,
                                                  np.random.default_rng(seed))
    t = taug.SparseFlowAugmentor(CROP, -0.2, 0.4)(img1, img2, flow, valid,
                                                  np.random.default_rng(seed))
    assert t[3].dtype == bool and t[3].shape == CROP
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("name", ["chairs", "things", "sintel", "kitti", "hd1k"])
def test_dataset_items_match_jax(trees, name, augment):
    jd, td = _build(jds, name, trees[name], augment), _build(tds, name, trees[name], augment)
    assert len(td) == len(jd) > 0
    assert td.image_list == jd.image_list and td.flow_list == jd.flow_list
    for i in range(len(td)):
        t = td.__getitem__(i, rng=np.random.default_rng(i))
        j = jd.__getitem__(i, rng=np.random.default_rng(i))
        _assert_items_equal(t, j, f"{name} item {i}")
        if augment:
            assert t["ref"].shape[:2] == CROP


def test_combined_dataset_matches_jax(trees):
    jc = jds.CombinedDataset([_build(jds, "kitti", trees["kitti"], True),
                              _build(jds, "sintel", trees["sintel"], True)], [2, 1])
    tc = tds.CombinedDataset([_build(tds, "kitti", trees["kitti"], True),
                              _build(tds, "sintel", trees["sintel"], True)], [2, 1])
    assert len(tc) == len(jc) == 2 * 3 + 4 and tc.index == jc.index
    for i in range(len(tc)):
        _assert_items_equal(tc.__getitem__(i, rng=np.random.default_rng(i)),
                            jc.__getitem__(i, rng=np.random.default_rng(i)), f"item {i}")


def test_collation_matches_jax(trees):
    """Two epochs of both loaders over the augmented KITTI tree: images padded
    to /128, flow GT and its mask at the crop, every array equal."""
    loaders = [L(_build(mod, "kitti", trees["kitti"], True), 2, workers=1, pad_multiple=128,
                 seed=3) for L, mod in ((TLoader, tds), (JLoader, jds))]
    for epoch in range(2):
        tb, jb = (list(ld) for ld in loaders)
        assert len(tb) == len(jb) == 1
        for t, j in zip(tb, jb):
            _assert_items_equal(t, j, f"epoch {epoch}")
            assert t["ref"].shape == (2, 128, 128, 3)
            assert t["flow_gt"].shape == (2, *CROP, 2) and t["flow_valid"].shape == (2, *CROP)


def _fake_forward(pair):
    """A flow 'network' both evaluators can call: (1, H, W, 6) -> (1, H, W, 2)."""
    pair = np.asarray(pair, np.float32)
    return 3.0 * pair[..., :2] - pair[..., 3:5]


@pytest.mark.parametrize("name", ["kitti", "sintel"])
def test_flow_evaluation_and_submissions_match_jax(trees, name, tmp_path):
    """`train/flow_eval.py` against JAX's on the same datasets and forward:
    EPE and Fl-all (pairs padded to /64, cropped back), and the Sintel .flo
    and KITTI PNG submission files, read back equal."""
    from deep_sfm_revisited_tpu.train import flow_eval as jev
    from deep_sfm_revisited_tpu_torch.train import flow_eval as tev

    jd, td = _build(jds, name, trees[name], False), _build(tds, name, trees[name], False)
    got = tev.evaluate_flow_dataset(_fake_forward, td, pad_multiple=64)
    want = jev.evaluate_flow_dataset(_fake_forward, jd, pad_multiple=64)
    assert got["n"] == want["n"] == len(td)
    for k in ("epe", "f1_all"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    tw, jw = (tev.create_kitti_submission, jev.create_kitti_submission) if name == "kitti" \
        else (tev.create_sintel_submission, jev.create_sintel_submission)
    tw(_fake_forward, td, str(tmp_path / "port"))
    jw(_fake_forward, jd, str(tmp_path / "jax"))
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == len(td)
    for f in files:
        a, b = str(tmp_path / "port" / f), str(tmp_path / "jax" / f)
        if name == "kitti":
            for x, y in zip(jio.read_flow_kitti(a), jio.read_flow_kitti(b)):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(jio.read_flo(a), jio.read_flo(b))
