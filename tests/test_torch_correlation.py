"""The port's windowed correlation (kernel B2's plain version) against the
JAX package's XLA function and its Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.ops.correlation import local_correlation as j_corr
from deep_sfm_revisited_tpu.ops.pallas.local_corr import local_correlation_pallas
from deep_sfm_revisited_tpu_torch.ops import correlation as tcorr

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
