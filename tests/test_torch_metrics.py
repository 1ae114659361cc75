"""The port's Eigen metrics and motion errors against the JAX package's, on
random depths, masks and poses (NaN ground-truth rows and padded inputs
included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.ops import rotations as jrot
from deep_sfm_revisited_tpu.train import metrics as jm
from deep_sfm_revisited_tpu_torch.ops import rotations as trot
from deep_sfm_revisited_tpu_torch.train import metrics as tm

B, H, W = 3, 40, 64
RAW = np.array([[37, 61], [40, 64], [33, 50]], np.int32)


def _depths(seed=0):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(1.0, 90.0, (B, H, W)).astype(np.float32)
    gt[rng.rand(B, H, W) < 0.6] = 0.0          # sparse, like LiDAR
    gt[0, 30] = np.nan                          # a NaN ground-truth row
    gt[2, :, 55:] = 7.0                         # nonzero values in the padding
    pred = (gt * rng.uniform(0.5, 2.0, (B, 1, 1)) + rng.uniform(0.1, 3.0, (B, H, W)))
    pred = np.nan_to_num(pred, nan=5.0).astype(np.float32)
    return gt, pred


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("raw", [False, True])
def test_masks_equal_jax(raw):
    gt, _ = _depths()
    raw_hw = RAW if raw else None
    np.testing.assert_array_equal(
        tm.eigen_crop_mask(_t(gt), raw_hw=None if raw_hw is None else _t(raw_hw)).numpy(),
        np.asarray(jm.eigen_crop_mask(jnp.asarray(gt), raw_hw=raw_hw)))
    np.testing.assert_array_equal(
        tm.demon_mask(_t(gt) / 8.0, raw_hw=None if raw_hw is None else _t(raw_hw)).numpy(),
        np.asarray(jm.demon_mask(jnp.asarray(gt) / 8.0, raw_hw=raw_hw)))


@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_masked_median_equals_both_jax_forms(density):
    """Exact: the same order statistics (the JAX sort and bisection forms),
    including an empty mask (1.0) and even and odd counts."""
    rng = np.random.RandomState(int(density * 100))
    x = rng.uniform(-5, 5, 1001).astype(np.float32)
    for m in (rng.rand(1001) < density, rng.rand(1000) < density):
        xx = x[:m.size]
        got = float(tm._masked_median(_t(xx), _t(m)))
        assert got == float(jm._masked_median_sort(jnp.asarray(xx), jnp.asarray(m)))
        assert got == float(jm._masked_median(jnp.asarray(xx), jnp.asarray(m)))


# float32 means over ~1e3 pixels summed in another order: 2e-6 relative
@pytest.mark.parametrize("protocol", ["eigen", "demon"])
@pytest.mark.parametrize("raw", [False, True])
def test_evaluate_depth_equals_jax(protocol, raw):
    gt, pred = _depths(1)
    if protocol == "demon":
        gt, pred = gt / 8.0, pred / 8.0
    raw_hw = RAW if raw else None
    kw = dict(nlabel=64, min_depth=0.5, protocol=protocol)
    j = jm.evaluate_depth(jnp.asarray(pred), jnp.asarray(gt), raw_hw=raw_hw, **kw)
    t = tm.evaluate_depth(_t(pred), _t(gt), raw_hw=None if raw_hw is None else _t(raw_hw), **kw)
    assert set(t) == set(j) and len(t) == 9
    for k in j:
        assert np.isfinite(float(t[k])), k
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=2e-6, atol=1e-7, err_msg=k)


def test_median_scale_align_and_depth_metrics_equal_jax():
    gt, pred = _depths(2)
    mask = np.asarray(jm.eigen_crop_mask(jnp.asarray(gt)))
    np.testing.assert_allclose(
        tm.median_scale_align(_t(pred), _t(gt), _t(mask)).numpy(),
        np.asarray(jm.median_scale_align(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))),
        rtol=1e-6)
    j = jm.depth_metrics(jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(mask))
    t = tm.depth_metrics(_t(gt), _t(pred), _t(mask))
    for k in j:
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=2e-6, err_msg=k)


def _poses(n, seed):
    rng = np.random.RandomState(seed)
    ang = rng.uniform(-np.pi, np.pi, (n, 3))
    ang[0] = [np.pi, 0.0, 0.0]                  # trace -1: the w-small branches
    ang[1] = 0.0
    R = np.asarray(jrot.angle_to_matrix(jnp.asarray(ang)))
    t = rng.randn(n, 3, 1)
    return np.concatenate([R, t], axis=-1)


# float64 rotations: 1e-12; the angles near 0 lose digits in arccos: 1e-6
def test_motion_errors_and_quaternions_equal_jax():
    P, G = _poses(16, 0), _poses(16, 1)
    np.testing.assert_allclose(trot.matrix_to_quat(_t(P[..., :3])).numpy(),
                               np.asarray(jrot.matrix_to_quat(jnp.asarray(P[..., :3]))),
                               rtol=0, atol=1e-12)
    for t, j in zip(tm.motion_errors(_t(P), _t(G)), jm.motion_errors(jnp.asarray(P),
                                                                     jnp.asarray(G))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
    rot, _, ang = tm.motion_errors(_t(P), _t(P))
    assert float(rot.abs().max()) < 1e-6 and float(ang.abs().max()) < 1e-6
