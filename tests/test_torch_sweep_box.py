"""The sweep backward kernel's box rule (`ops/camera.py::sweep_tap_box_plain`)
and its work counts (`sweep_backward_counts`), on the CPU.

The kernel adds a tile group's samples into a shared-memory box of target
pixels when the rule says the box holds every tap they touch; a sample
whose taps leave it adds to device memory directly, so a loose rule costs
time and never a wrong sum. These tests hold the rule to the stronger claim
the kernel's speed rests on: over random poses, tiles and group sizes, and
over edge poses (points near the z = 1e-3 plane, behind the camera, out of
the frame), every tap of every valid sample lies in its group's box or the
group is marked direct. The samples are the forward's own
(`sweep_pixel_coords`, B1's tap rule), as the kernel takes them.
"""

import math

import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu_torch.ops import camera, rotations
from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp

torch.set_num_threads(2)
TILES = [(8, 8), (4, 16), (2, 32), (1, 8), (16, 16), (5, 8)]


def _inputs(rng, B, D, H, W, t=None, angle=0.1):
    """depths (PSNet's D / label spacing from 1), M, Kt of a random K and pose."""
    f = rng.uniform(0.4, 1.2) * W
    K = torch.tensor([[f, 0, W / 2 + rng.uniform(-2, 2)], [0, f, H / 2 + rng.uniform(-2, 2)],
                      [0, 0, 1]], dtype=torch.float32)
    R = torch.stack([rotations.angle_to_matrix(torch.tensor(rng.uniform(-angle, angle, 3),
                                                            dtype=torch.float32))
                     for _ in range(B)])
    tt = torch.tensor(rng.uniform(-1, 1, (B, 3)) if t is None else np.tile(t, (B, 1)),
                      dtype=torch.float32)
    pose = torch.cat([R, tt[:, :, None]], dim=2)
    M, Kt = camera.sweep_matrices(pose, K.expand(B, 3, 3), torch.linalg.inv(K).expand(B, 3, 3))
    depths = D / torch.arange(1, D + 1, dtype=torch.float32)
    return depths, M, Kt


def _check(depths, M, Kt, H, W, tile, planes, cap=10**9):
    counts = camera.sweep_backward_counts(depths, M, Kt, H, W, 8, *tile, planes, cap)
    assert counts["left_box_samples"] == 0, counts
    groups = M.shape[0] * math.ceil(H / tile[0]) * math.ceil(W / tile[1]) * math.ceil(
        depths.shape[0] / planes)
    assert counts["shared_groups"] + counts["direct_groups"] == groups
    return counts


@pytest.mark.parametrize("seed", range(6))
def test_every_valid_tap_lies_in_its_box_random_poses(seed):
    """Random intrinsics, rotations up to 0.1 rad a side and translations in
    [-1, 1]^3, each tile shape and 1, 3 or 8 planes a group."""
    rng = np.random.RandomState(seed)
    depths, M, Kt = _inputs(rng, 2, 24, 20, 36)
    shared = 0
    for tile in TILES:
        for planes in (1, 3, 8):
            shared += _check(depths, M, Kt, 20, 36, tile, planes)["shared_groups"]
    assert shared > 0


@pytest.mark.parametrize("kind", ["near the horizon", "behind the camera", "out of frame",
                                  "pure rotation"])
def test_every_valid_tap_lies_in_its_box_edge_poses(kind):
    """Points within rounding of z = 1e-3 (K t's z just below the nearest
    plane), planes behind the camera, samples pushed off the frame, and no
    translation at all (every plane maps alike)."""
    rng = np.random.RandomState(10)
    H, W, D = 24, 40, 16
    t = {"near the horizon": (0.3, 0.1, -1.0 + 1.5e-3), "behind the camera": (0.1, -0.1, -2.5),
         "out of frame": (40.0, 0.5, 0.3), "pure rotation": (0.0, 0.0, 0.0)}[kind]
    depths, M, Kt = _inputs(rng, 1, D, H, W, t=t, angle=0.02)
    if kind == "near the horizon":
        depths = torch.linspace(1.0, 0.5, D)          # z = d - 1 + 1.5e-3 crosses 1e-3
    counts = [_check(depths, M, Kt, H, W, tile, planes) for tile in TILES for planes in (1, 4)]
    if kind in ("near the horizon", "behind the camera"):
        assert all(c["direct_groups"] > 0 for c in counts)
    if kind == "out of frame":
        box = camera.sweep_tap_box_plain(depths, M, Kt, H, W, 8, 8, 4, 10**9)
        assert bool(((box["w"] * box["h"]) == 0).any())
    if kind == "pure rotation":
        assert all(c["direct_groups"] == 0 for c in counts)


def test_box_is_the_padded_hull_of_the_corner_samples():
    """Away from the frame's edges and the camera plane, the box spans the
    corner samples' taps plus one pixel of rounding on each side: width
    floor(x_max) - floor(x_min) + 4, and no group is direct."""
    rng = np.random.RandomState(3)
    H, W, D = 64, 64, 8
    depths, M, Kt = _inputs(rng, 1, D, H, W, t=(0.01, 0.005, 0.02), angle=0.0)
    box = camera.sweep_tap_box_plain(depths, M, Kt, H, W, 8, 8, D, 10**9)
    x, y = camera.sweep_pixel_coords(depths, M, Kt, H, W)
    ty, tx = 3, 4                                    # a tile well inside the frame
    xs = x[0, :, ty * 8:ty * 8 + 8, tx * 8:tx * 8 + 8]
    ys = y[0, :, ty * 8:ty * 8 + 8, tx * 8:tx * 8 + 8]
    assert not bool(box["direct"].any())
    assert int(box["x0"][0, ty, tx, 0]) == int(torch.floor(xs.min())) - 1
    assert int(box["w"][0, ty, tx, 0]) == int(torch.floor(xs.max()) - torch.floor(xs.min())) + 4
    assert int(box["y0"][0, ty, tx, 0]) == int(torch.floor(ys.min())) - 1
    assert int(box["h"][0, ty, tx, 0]) == int(torch.floor(ys.max()) - torch.floor(ys.min())) + 4


def test_a_box_larger_than_the_accumulator_goes_direct():
    """`cap` (the box pixels the shared accumulator holds) decides the path:
    every group direct below the smallest box, none above the largest, and
    the direct samples counted as 16-byte reductions, C / 4 per tap."""
    rng = np.random.RandomState(5)
    H, W, D, C = 20, 36, 12, 8
    depths, M, Kt = _inputs(rng, 1, D, H, W)
    box = camera.sweep_tap_box_plain(depths, M, Kt, H, W, 8, 8, 4, 10**9)
    area = box["w"] * box["h"]
    assert not bool(box["direct"].any())
    small = camera.sweep_backward_counts(depths, M, Kt, H, W, C, 8, 8, 4, 0)
    big = camera.sweep_backward_counts(depths, M, Kt, H, W, C, 8, 8, 4, int(area.max()))
    x, y = camera.sweep_pixel_coords(depths, M, Kt, H, W)
    valid = int(((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)).sum())
    assert small["shared_groups"] == int((area == 0).sum())
    assert small["global_reductions"] == valid * C
    assert big["direct_groups"] == 0 and big["left_box_samples"] == 0
    assert big["global_reductions"] == int(area.sum()) * C // 4


@pytest.mark.parametrize("C,itemsize", [(32, 2), (32, 4), (8, 2), (64, 2), (24, 4), (8, 4)])
def test_backward_plan_fills_a_block(C, itemsize):
    """The default work mapping `backward_plan` (the kernel's defaults,
    mirrored): a tile whose pixels times threads a pixel make at least a
    warp and at most 256 threads, and a shared accumulator of at least one
    8 x 8 box of C float32 channels."""
    tile_h, tile_w, planes, smem = sweep_warp.backward_plan(C, itemsize)
    tpp = C * itemsize // 16
    assert 32 <= tile_h * tile_w * tpp <= 256
    assert planes >= 1 and smem >= 64 * C * 4
