"""DICL's train-mode forward in the port against the JAX module, in float64.

The recipe trains depth with DICL frozen (`train.fix_flownet`), but DICL
still runs in train mode: the U-net once per frame with BN on batch
statistics, the per-level flow stack (`all_iters`), and BN running
statistics updated as JAX's `mutable=["batch_stats"]` step updates them.
The port runs it under `torch.no_grad()`. 128x128 pairs; weights through
the bridge, with their statistics off the init values. Float64 on both
sides (as tests/test_torch_train_psnet.py): normalizing by batch statistics
amplifies float32 rounding, and in float32 the two frameworks' flows part by
up to 1.5e-3 px; in float64 by 2.7e-5 px (the warps' coordinates are float32
on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables, t2n

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models import dicl as jdicl
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models import dicl as tdicl
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)
B, H, W = 1, 128, 128


@pytest.fixture(scope="module")
def train_forward():
    rng = np.random.RandomState(0)
    ref = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    tgt = (np.roll(ref, (2, 3), axis=(1, 2)) + 0.05 * rng.randn(B, H, W, 3)).astype(np.float32)
    pair = np.concatenate([ref, tgt], axis=-1).astype(np.float64)
    jnet = jdicl.DICLFlow(JConfig.kitti().flow, dtype=jnp.float64)
    variables = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.float64),
        random_variables(jnet.init, jax.random.PRNGKey(0), jnp.asarray(pair), seed=1))
    (jstack, jent), upd = jax.jit(lambda v, p: jnet.apply(
        v, p, train=True, all_iters=True, mutable=["batch_stats"]))(variables, jnp.asarray(pair))
    entries = weights.dicl_entries("", "")
    jstats = weights.convert({"params": variables["params"], "batch_stats": upd["batch_stats"]},
                             entries)
    tnet = tdicl.DICLFlow(TConfig.kitti().flow)
    load_strict(tnet, weights.convert(variables, entries)).double().train()
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    with torch.no_grad():
        tstack, tent = tnet(torch.from_numpy(pair), all_iters=True)
        after = {k: v.clone() for k, v in tnet.state_dict().items()}
        tflow, _ = tnet(torch.from_numpy(pair))
    return dict(jstack=np.asarray(jstack), jent=np.asarray(jent), jstats=jstats,
                tstack=t2n(tstack), tent=t2n(tent), tflow=t2n(tflow), before=before, after=after)


# flows to 1e-4 px (measured 2.7e-5), the entropy to 1e-5
def test_train_flow_stack_matches_jax(train_forward):
    """10 flows at full resolution, coarse to fine: each level's pre-context
    and refined flow (SUP_RAW_FLOW), the last one the flow RANSAC gets."""
    j, t = train_forward["jstack"], train_forward["tstack"]
    assert t.shape == j.shape == (10, B, H, W, 2)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)
    # the stack's last flow is the flow of a plain train-mode forward
    np.testing.assert_allclose(t[-1], train_forward["tflow"], rtol=0, atol=1e-6)


def test_train_entropy_matches_jax(train_forward):
    t, j = train_forward["tent"], train_forward["jent"]
    assert t.shape == (B, H, W, 1)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


def test_train_batch_statistics_match_jax(train_forward):
    """Every BN's running mean and variance after one train forward (flax's
    rule, biased variance), to 1e-6 relative (the bridge stores JAX's in
    float32); each moved off its value."""
    jstats, before, after = (train_forward[k] for k in ("jstats", "before", "after"))
    keys = [k for k in jstats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 100
    for k in keys:
        assert not torch.equal(after[k], before[k]), k
        np.testing.assert_allclose(after[k].numpy(), jstats[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_train_mode_with_gradients_raises():
    """Train mode with autograd on (flow pretraining) no longer raises: it
    gives the stack a frozen forward under no_grad gives, now with a graph
    (its gradients against JAX: tests/test_torch_flow_train.py)."""
    net = tdicl.DICLFlow(TConfig.kitti().flow).train()
    x = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (B, H, W, 6)).astype(np.float32))
    with torch.no_grad():
        frozen, _ = net(x, all_iters=True)
    stack, _ = net(x, all_iters=True)
    assert stack.requires_grad and not frozen.requires_grad
    assert torch.equal(stack.detach(), frozen)
