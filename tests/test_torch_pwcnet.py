"""The port's PWC-DC flow network against the JAX one, in float32.

One set of flax variables (numpy seed, `tests/torch_parity.py`), carried to
the port by the weight bridge's PWC table and loaded strictly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables, t2n

from deep_sfm_revisited_tpu.config import FlowConfig as JFlow
from deep_sfm_revisited_tpu.models.pwcnet import PWCDCNet as JPWC
from deep_sfm_revisited_tpu_torch.config import FlowConfig as TFlow
from deep_sfm_revisited_tpu_torch.models.pwcnet import PWCDCNet as TPWC
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)
B, H, W = 1, 64, 128


@pytest.fixture(scope="module")
def pwc():
    rng = np.random.RandomState(0)
    pair = rng.uniform(-1, 1, (B, H, W, 6)).astype(np.float32)
    pair[..., 3:] = np.roll(pair[..., :3], (1, 2), axis=(1, 2)) + 0.05 * rng.randn(B, H, W, 3)
    jnet = JPWC(JFlow(estimator="PWC"))
    variables = random_variables(lambda p: jnet.init(jax.random.PRNGKey(0), p),
                                 jnp.asarray(pair), seed=1)
    jflow, jconf = jax.jit(jnet.apply)(variables, jnp.asarray(pair))
    sd = weights.convert(variables, weights.pwc_entries(t="", f=""))
    tnet = load_strict(TPWC(TFlow(estimator="PWC")), sd).eval()
    with torch.no_grad():
        tflow, tconf = tnet(torch.from_numpy(pair))
    return dict(variables=variables, sd=sd, jflow=np.asarray(jflow), jconf=jconf,
                tflow=t2n(tflow), tconf=tconf, tnet=tnet, pair=pair)


def test_bridge_converts_every_leaf(pwc):
    """126 flax leaves, 9,374,274 parameters, each feeding one tensor."""
    leaves = jax.tree_util.tree_leaves(pwc["variables"])
    assert len(leaves) == 126 == len(pwc["sd"])
    assert sum(int(np.prod(x.shape)) for x in leaves) == 9_374_274
    assert sum(p.numel() for p in pwc["tnet"].parameters()) == 9_374_274


def test_upstream_names(pwc):
    sd = pwc["sd"]
    for key in ("conv1a.0.weight", "conv6aa.0.bias", "conv2_4.0.weight",
                "predict_flow6.weight", "deconv3.bias", "upfeat6.weight",
                "dc_conv1.0.weight", "dc_conv7.bias"):
        assert key in sd, key


# flow: 1e-3 px after the x20 (float32 convolutions, sums in other orders)
def test_flow_matches_jax(pwc):
    assert pwc["tflow"].shape == (B, H, W, 2) and pwc["tconf"] is None and pwc["jconf"] is None
    assert np.abs(pwc["jflow"]).max() > 1e-2        # not a vacuous comparison
    np.testing.assert_allclose(pwc["tflow"], pwc["jflow"], rtol=0, atol=1e-3)


def test_train_mode_raises(pwc):
    """PWC-DC trains: in train mode with autograd on it computes the eval
    flow and a gradient reaches every parameter (through both correlations'
    autograd functions and the warp's flow). What raises in train mode as
    in eval is an input whose sides are not multiples of 64, with a
    ValueError naming the rule."""
    net = pwc["tnet"].train()
    try:
        net.zero_grad(set_to_none=True)
        flow, _ = net(torch.from_numpy(pwc["pair"]))
        np.testing.assert_allclose(t2n(flow), pwc["tflow"], rtol=0, atol=1e-5)
        flow.square().mean().backward()
        for k, p in net.named_parameters():
            assert p.grad is not None and p.grad.abs().max() > 0, k
        with pytest.raises(ValueError, match="multiples of 64"):
            net(torch.zeros(1, 72, 104, 6))
    finally:
        net.zero_grad(set_to_none=True)
        net.eval()


@pytest.mark.parametrize("hw", [(72, 104), (64, 96)])
def test_sizes_not_multiples_of_64_raise_as_in_jax(pwc, hw):
    """At a size that is not /64 the JAX network fails too: a level's
    up-sampled flow and its features differ by a row or a column, and its
    warp's broadcast raises a TypeError (traced abstractly, no compile).
    The port raises a ValueError that names the rule before any layer."""
    jnet = JPWC(JFlow(estimator="PWC"))
    x = jax.ShapeDtypeStruct((1, *hw, 6), jnp.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda p: jnet.apply(pwc["variables"], p), x)
    with torch.no_grad(), pytest.raises(ValueError, match="multiples of 64"):
        pwc["tnet"](torch.zeros(1, *hw, 6))
