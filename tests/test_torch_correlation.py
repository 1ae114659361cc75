"""The port's windowed correlation (kernel B2's plain version) against the
JAX package's XLA function and its Pallas kernel in interpret mode, and
B2's work mapping (`ops/cuda/local_corr.py::plan`), which needs no card."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.ops.correlation import local_correlation as j_corr
from deep_sfm_revisited_tpu.ops.pallas.local_corr import local_correlation_pallas
from deep_sfm_revisited_tpu_torch.ops import correlation as tcorr
from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr as lc

torch.set_num_threads(1)


def _features(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


# float32 sums of <= 196 products of unit normals, reduced in another order
# by XLA and by torch: 1e-6 absolute on outputs of order 0.1
@pytest.mark.parametrize("shape", [(1, 6, 20, 196), (2, 7, 13, 96), (1, 9, 11, 32)])
def test_plain_matches_xla(shape):
    f0, f1 = _features(shape, seed=shape[-1])
    ref = np.asarray(j_corr(jnp.asarray(f0), jnp.asarray(f1), 4))
    got = tcorr.local_correlation(torch.from_numpy(f0), torch.from_numpy(f1), 4).numpy()
    assert got.shape == shape[:3] + (81,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_plain_matches_pallas_interpret():
    """md=2, as tests/test_correlation.py runs the Pallas kernel (its body
    multiplies by 1/C where the XLA function divides: 1e-6)."""
    f0, f1 = _features((2, 20, 32, 8), seed=1)
    ref = np.asarray(local_correlation_pallas(jnp.asarray(f0), jnp.asarray(f1), 2, 4, True))
    got = tcorr.local_correlation(torch.from_numpy(f0), torch.from_numpy(f1), 2).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dy,dx", [(0, 0), (0, 1), (1, 0), (-1, 1), (-2, -2)])
def test_channel_order(dy, dx):
    """A delta at (y+dy, x+dx) lands on channel (dy+md)(2md+1) + (dx+md)."""
    f0 = torch.zeros(1, 7, 9, 2)
    f1 = torch.zeros(1, 7, 9, 2)
    f0[0, 3, 4] = 1.0
    f1[0, 3 + dy, 4 + dx] = 1.0
    corr = tcorr.local_correlation(f0, f1, 2)
    assert int(torch.argmax(corr[0, 3, 4])) == (dy + 2) * 5 + (dx + 2)
    assert float(corr[0, 3, 4].max()) == 1.0           # C unit products / C


def test_zero_outside_the_frame():
    """Every displacement that leaves the frame gives exactly zero; inside
    it all-ones features give 1 (sum over C / C)."""
    md = 4
    f = torch.ones(1, 6, 7, 3)
    corr = tcorr.local_correlation(f, f, md)
    ys, xs = torch.meshgrid(torch.arange(6), torch.arange(7), indexing="ij")
    for k in range((2 * md + 1) ** 2):
        dy, dx = k // (2 * md + 1) - md, k % (2 * md + 1) - md
        inside = (ys + dy >= 0) & (ys + dy < 6) & (xs + dx >= 0) & (xs + dx < 7)
        torch.testing.assert_close(corr[0, ..., k], inside.float(), rtol=0, atol=0)


def test_other_devices_raise():
    f = torch.zeros(1, 4, 4, 2, device="meta")
    with pytest.raises(NotImplementedError):
        tcorr.local_correlation(f, f, 1)


# PWC-DC's five level shapes (levels 6..2 of a 384x1280 pair), then the odd
# shapes of the card tests
PLAN_SHAPES = [(1, 6, 20, 196), (1, 12, 40, 128), (1, 24, 80, 96), (1, 48, 160, 64),
               (1, 96, 320, 32), (2, 13, 27, 40), (1, 5, 7, 3)]


def _kernel_constant(name):
    src = (Path(lc.__file__).resolve().parents[2] / "csrc" / "local_corr.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("md", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_b2_plan_covers_the_output(shape, md):
    """Kernel B2's work mapping (`local_corr.plan`), replayed with the
    kernel's index arithmetic: every (pixel, dy row) is summed by exactly one
    thread of each cluster rank, every output element is written exactly
    once, the ranks' channel shares partition C, and the sizes are ones the
    source instantiates."""
    B, H, W, C = shape
    s = 2 * md + 1
    p = lc.plan(B, H, W, C, md)
    assert (lc.TILE_H, lc.THREAD_COLS, lc.MAX_CLUSTER) == (
        _kernel_constant("kTileH"), _kernel_constant("kCols"), _kernel_constant("kMaxCluster"))
    assert p.px in lc.PIXELS_PER_THREAD and p.block == (lc.THREAD_COLS, lc.TILE_H, s)
    assert 1 <= p.cluster <= lc.MAX_CLUSTER and p.cluster <= -(-C // 4)
    assert p.grid[0] % p.cluster == 0 and p.grid[2] == B

    # channel shares: contiguous, non-empty, on groups of 4, covering [0, C)
    assert p.shares[0][0] == 0 and p.shares[-1][1] == C
    for (b0, e0), (b1, _) in zip(p.shares, p.shares[1:]):
        assert e0 == b1
    assert all(b < e and b % 4 == 0 for b, e in p.shares)

    threads = s * lc.TILE_H * lc.THREAD_COLS
    tx, ty, dyr = np.meshgrid(np.arange(lc.THREAD_COLS), np.arange(lc.TILE_H), np.arange(s),
                              indexing="ij")
    summed = np.zeros((p.cluster, B, H, W, s), np.int64)
    written = np.zeros((B, H, W, s * s), np.int64)
    for gx in range(p.grid[0]):
        rank, x0 = gx % p.cluster, (gx // p.cluster) * p.tile_w
        nx = min(p.tile_w, W - x0)
        i = np.arange(nx * s * s)
        mine = i[(i // threads) % p.cluster == rank]      # the strided reduction loop
        for gy in range(p.grid[1]):
            y0 = gy * lc.TILE_H
            for b in range(B):
                for q in range(p.px):
                    xs, ys = x0 + tx * p.px + q, y0 + ty
                    m = (xs < W) & (ys < H)
                    np.add.at(summed, (rank, b, ys[m], xs[m], dyr[m]), 1)
                for r in range(min(lc.TILE_H, H - y0)):
                    np.add.at(written, (b, y0 + r, x0 + mine // (s * s), mine % (s * s)), 1)
    assert (summed == 1).all() and (written == 1).all()

    if shape == PLAN_SHAPES[0] and md == 4:
        # PWC-DC's level 6: 120 pixels, yet several hundred warps in flight
        assert p.warps >= 400, p
