"""The port's flow losses (`train/losses.py`: `flow_epe`, `flow_sequence_loss`,
`multiscale_flow_loss`, and `train/flow_trainer.py::flow_loss`) against the
JAX package's, on flows made with numpy from a seed.

The multiscale loss is checked with DICL's level weights and valid ranges
(a few GT pixels beyond a range, zeroed but still counted), with and without
a valid mask, on a full-resolution stack (DICL's `all_iters` output) and on
a coarse pyramid (pooled GT). A GT that does not tile the prediction (DICL's
input padded to /128 while `flow_gt` is not) raises in both packages.
Tolerance: 1e-6 relative in float32 (the same sums in other orders), 1e-12
in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.config import FlowConfig as JFlowConfig
from deep_sfm_revisited_tpu.train import flow_trainer as jft
from deep_sfm_revisited_tpu.train import losses as jl
from deep_sfm_revisited_tpu_torch.config import FlowConfig as TFlowConfig
from deep_sfm_revisited_tpu_torch.train import flow_trainer as tft
from deep_sfm_revisited_tpu_torch.train import losses as tl

B, H, W = 2, 32, 48


def _data(seed, dtype=np.float32, L=10):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-50, 50, (B, H, W, 2))
    gt[0, :4, :4] = (400.0, -10.0)       # beyond every level's range
    gt[1, 5, 7] = (0.0, 350.0)           # beyond the coarse levels' only
    preds = gt[None] + rng.normal(0, 3, (L, B, H, W, 2))
    valid = rng.random((B, H, W)) < 0.7
    return preds.astype(dtype), gt.astype(dtype), valid


def _close(got, want, dtype):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("masked", [False, True])
def test_epe_and_sequence_loss_match_jax(dtype, masked):
    preds, gt, valid = _data(0, dtype, L=4)
    v = valid if masked else None
    tv = torch.from_numpy(valid) if masked else None
    _close(tl.flow_epe(torch.from_numpy(preds[-1]), torch.from_numpy(gt), tv),
           jl.flow_epe(jnp.asarray(preds[-1]), jnp.asarray(gt), v), dtype)
    _close(tl.flow_sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt), tv, gamma=0.7,
                                 max_flow=300.0),
           jl.flow_sequence_loss(jnp.asarray(preds), jnp.asarray(gt), v, gamma=0.7,
                                 max_flow=300.0), dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("masked", [False, True])
def test_multiscale_loss_matches_jax(dtype, masked):
    """DICL's 10-flow stack at full resolution with its weights and ranges
    (through `flow_loss`), and a pyramid of coarse levels with GT pooling."""
    preds, gt, valid = _data(1, dtype)
    v = valid if masked else None
    tv = torch.from_numpy(valid) if masked else None
    want = jl.multiscale_flow_loss(list(jnp.asarray(preds)), jnp.asarray(gt),
                                   jft.DICL_LEVEL_WEIGHTS[::-1], v,
                                   valid_range=jft.DICL_VALID_RANGE[::-1])
    got = tft.flow_loss(TFlowConfig(estimator="DICL"), torch.from_numpy(preds),
                        torch.from_numpy(gt), tv)
    assert tft.DICL_LEVEL_WEIGHTS == jft.DICL_LEVEL_WEIGHTS
    assert tft.DICL_VALID_RANGE == jft.DICL_VALID_RANGE
    _close(got, want, dtype)
    # without ranges the gates change the value (the GT beyond them counts)
    ungated = tl.multiscale_flow_loss(list(torch.from_numpy(preds)), torch.from_numpy(gt),
                                      jft.DICL_LEVEL_WEIGHTS[::-1], tv)
    assert float(ungated) > float(got)
    rng = np.random.default_rng(2)
    pyramid = [rng.normal(0, 5, (B, H // f, W // f, 2)).astype(dtype) for f in (16, 8, 4, 2)]
    weights = (0.32, 0.08, 0.02, 0.01)
    ranges = ((20, 30), (40, 40), (60, 80))
    _close(tl.multiscale_flow_loss([torch.from_numpy(p) for p in pyramid], torch.from_numpy(gt),
                                   weights, tv, valid_range=ranges),
           jl.multiscale_flow_loss([jnp.asarray(p) for p in pyramid], jnp.asarray(gt), weights,
                                   v, valid_range=ranges), dtype)


def test_flow_loss_matches_the_jax_step_for_raft():
    """Off DICL, `flow_loss` is the sequence loss at gamma 0.8 (JAX's step)."""
    preds, gt, valid = _data(3, L=3)
    _close(tft.flow_loss(TFlowConfig(estimator="RAFT"), torch.from_numpy(preds),
                         torch.from_numpy(gt), torch.from_numpy(valid)),
           jl.flow_sequence_loss(jnp.asarray(preds), jnp.asarray(gt), valid, gamma=0.8),
           np.float32)
    assert JFlowConfig().estimator == TFlowConfig().estimator


def test_unpadded_gt_raises_in_both_packages():
    """DICL at KITTIFlow's default crop (288, 960): the loader pads the images
    to 384x1024 and leaves the GT at 288x960, which tiles no prediction. JAX's
    reshape raises a TypeError; the port raises first, naming the /128 rule."""
    rng = np.random.default_rng(4)
    gt = rng.normal(0, 5, (1, 288, 960, 2)).astype(np.float32)
    preds = rng.normal(0, 5, (2, 1, 384, 1024, 2)).astype(np.float32)
    with pytest.raises(TypeError, match="reshape"):
        jl.multiscale_flow_loss(list(jnp.asarray(preds)), jnp.asarray(gt), (1.0, 0.5))
    with pytest.raises(ValueError, match="multiples of 128"):
        tl.multiscale_flow_loss(list(torch.from_numpy(preds)), torch.from_numpy(gt), (1.0, 0.5))
