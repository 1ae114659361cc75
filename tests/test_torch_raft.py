"""The port's RAFT (`models/raft.py`) against the JAX package's, on the CPU.

One set of flax variables per module (numpy seed, `tests/torch_parity.py`:
every kernel, bias, norm scale and BatchNorm statistic off its init value),
carried by the weight bridge (`utils/weights.py`) and loaded strictly.

- Each module at 64x96 in float32: `ResBlock` with instance, batch and no
  norm (and a stride-2 projection), `BasicEncoder` with instance and batch
  norm in eval and train mode, `SepConvGRU`, `MotionEncoder`, `UpdateBlock`
  with and without the mask and `mask_only`, `convex_upsample`: to 1e-4 of
  the output's largest value (float32 convolutions summed in other orders).
- The correlation pyramid: each unpadded level within one bfloat16 ulp of
  JAX's padded level's interior (the product rounds in another order, and
  a value near a rounding boundary can cast the other way), JAX's pad all
  zeros.
- The lookup: `lookup_correlation_plain` against JAX's `lookup_correlation`
  on one pyramid (bf16 values, JAX's copy padded as JAX pads it), with
  coordinates on and off the frame, beyond the clip, negative and exactly
  on each clip bound: to 1e-6 in float32 (XLA and PyTorch round the blend's
  products and sums alike; measured 0) and to 1e-12 in float64 (float64
  levels holding the same bf16 values); the dx-major channel order by a
  level with one non-zero value.
- The whole RAFT: 3 eval iterations, and the 2-iteration `all_iters` stack
  in train mode, against JAX with one set of weights; the flow to 2e-3 px
  (the bf16 pyramid: float32 noise in the features can round a correlation
  the other way, by one bf16 ulp, and the recurrence carries it).
"""

import dataclasses

import jax
import jax.numpy as jnp
from flax import linen as nn
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables, t2n

from deep_sfm_revisited_tpu.config import FlowConfig as JFlow
from deep_sfm_revisited_tpu.models import raft as jraft
from deep_sfm_revisited_tpu_torch.config import FlowConfig as TFlow
from deep_sfm_revisited_tpu_torch.models import raft as traft
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)
B, H, W = 1, 64, 96
h, w = H // 8, W // 8
RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-3          # not a vacuous comparison
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t2n(t), 1, -1)


def _vars(module, *args, seed, **kw):
    return random_variables(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *args,
                            seed=seed)


@pytest.mark.parametrize("norm,cin,cout,stride", [("instance", 32, 64, 2), ("batch", 32, 32, 1),
                                                  ("none", 16, 48, 2), ("batch", 32, 64, 2)])
@pytest.mark.parametrize("train", [False, True])
def test_resblock_matches_jax(norm, cin, cout, stride, train):
    x = np.random.RandomState(1).randn(2, 16, 24, cin).astype(np.float32)
    jm = jraft.ResBlock(cout, stride, norm)
    v = _vars(jm, jnp.asarray(x), seed=2)
    want = jm.apply(v, jnp.asarray(x), train, mutable=["batch_stats"] if train else False)
    want = want[0] if train else want
    down = stride != 1 or cin != cout
    tm = load_strict(traft.ResBlock(cin, cout, norm, stride),
                     weights.convert(v, weights._resblock("", "", norm, down)))
    tm.train(train)
    _close(_nhwc(tm(_nchw(x))), want)


@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("train", [False, True])
def test_basic_encoder_matches_jax(norm, train):
    """Also: the instance norms' scale and bias are carried (they are off
    identity in the JAX variables)."""
    x = np.random.RandomState(3).uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    jm = jraft.BasicEncoder(160, norm)
    v = _vars(jm, jnp.asarray(x), seed=4)
    want = jm.apply(v, jnp.asarray(x), train, mutable=["batch_stats"] if train else False)
    want = want[0] if train else want
    sd = weights.convert(v, weights.basic_encoder_entries("", "", norm))
    if norm == "instance":
        assert not torch.allclose(sd["norm1.weight"], torch.ones(64))
    tm = load_strict(traft.BasicEncoder(160, norm), sd).train(train)
    got = tm(_nchw(x))
    assert got.shape == (2, 160, h, w)
    _close(_nhwc(got), want)


def test_sep_conv_gru_matches_jax():
    rng = np.random.RandomState(5)
    hid = np.tanh(rng.randn(B, h, w, 128)).astype(np.float32)
    x = rng.randn(B, h, w, 256).astype(np.float32)
    jm = jraft.SepConvGRU(128)
    v = _vars(jm, jnp.asarray(hid), jnp.asarray(x), seed=6)
    entries = [("conv2d_cat", ("convz1", "convr1"), "Conv_0"), ("conv2d", "convq1", "Conv_1"),
               ("conv2d_cat", ("convz2", "convr2"), "Conv_2"), ("conv2d", "convq2", "Conv_3")]
    tm = load_strict(traft.SepConvGRU(128, 256), weights.convert(v, entries))
    _close(_nhwc(tm(_nchw(hid), _nchw(x))), jm.apply(v, jnp.asarray(hid), jnp.asarray(x)))


def test_motion_encoder_matches_jax():
    rng = np.random.RandomState(7)
    flow = 3 * rng.randn(B, h, w, 2).astype(np.float32)
    corr = rng.randn(B, h, w, 324).astype(np.float32)
    jm = jraft.MotionEncoder()
    v = _vars(jm, jnp.asarray(flow), jnp.asarray(corr), seed=8)
    entries = [("conv2d", n, f"Conv_{i}")
               for i, n in enumerate(("convc1", "convc2", "convf1", "convf2", "conv"))]
    tm = load_strict(traft.MotionEncoder(324), weights.convert(v, entries))
    got = tm(_nchw(flow), _nchw(corr))
    assert got.shape == (B, 128, h, w)
    _close(_nhwc(got), jm.apply(v, jnp.asarray(flow), jnp.asarray(corr)))


@pytest.fixture(scope="module")
def update_block():
    rng = np.random.RandomState(9)
    args = (np.tanh(rng.randn(B, h, w, 128)), np.maximum(rng.randn(B, h, w, 128), 0),
            rng.randn(B, h, w, 324), 3 * rng.randn(B, h, w, 2))
    args = [jnp.asarray(a, jnp.float32) for a in args]
    jm = jraft.UpdateBlock(128)
    v = _vars(jm, *args, seed=10)
    entries = [(k, tuple(s.replace(".update_block.", "") for s in t) if isinstance(t, tuple)
                else t.replace(".update_block.", ""), f.replace("flow_net/UpdateBlock_0/", ""))
               for k, t, f in weights.raft_entries("", "flow_net") if "UpdateBlock_0" in f]
    tm = load_strict(traft.UpdateBlock(128, 128, 324), weights.convert(v, entries))
    return jm, v, tm, args


@pytest.mark.parametrize("need_mask", [True, False])
def test_update_block_matches_jax(update_block, need_mask):
    jm, v, tm, args = update_block
    jnet, jmask, jdflow = jm.apply(v, *args, need_mask=need_mask)
    tnet, tmask, tdflow = tm(*(_nchw(a) for a in args), need_mask=need_mask)
    _close(_nhwc(tnet), jnet)
    _close(_nhwc(tdflow), jdflow)
    if need_mask:
        assert tmask.shape == (B, 576, h, w)
        _close(_nhwc(tmask), jmask)
    else:
        assert tmask is None and jmask is None


def test_update_block_mask_only_matches_jax(update_block):
    jm, v, tm, args = update_block
    want = jm.apply(v, args[0], mask_only=True)
    _close(_nhwc(tm(_nchw(args[0]), mask_only=True)), want)
    # the fused heads' mask half, as the need_mask path computes it
    _, mask, _ = tm(*(_nchw(a) for a in args))
    _, jmask, _ = jm.apply(v, *args)
    _close(_nhwc(mask), jmask)


def test_convex_upsample_matches_jax():
    rng = np.random.RandomState(11)
    flow = (3 * rng.randn(2, h, w, 2)).astype(np.float32)
    mask = (2 * rng.randn(2, h, w, 576)).astype(np.float32)
    want = jraft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask))
    got = traft.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask))
    assert got.shape == (2, H, W, 2)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=1e-5)


def _features(seed, c=256):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, h, w, c).astype(np.float32) for _ in range(2)]


def _bf16_ulp(x):
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_pyramid_within_one_bf16_ulp_of_jax():
    """Level 0 within one bfloat16 ulp of JAX's (the float32 product sums in
    another order, so a value near a rounding boundary can cast the other
    way); each coarser level exactly flax's bf16 `avg_pool` of the port's
    level above it (the pooling rule bit for bit); JAX's pad all zeros."""
    f1, f2 = _features(12)
    jpyr, pad = jraft.correlation_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, 4)
    tpyr = traft.correlation_pyramid(_nchw(f1), _nchw(f2), 4)
    assert pad == 11 and len(tpyr) == 4
    for i, (jl, tl) in enumerate(zip(jpyr, tpyr)):
        jl = np.asarray(jl.astype(jnp.float32))
        assert tl.dtype == torch.bfloat16 and tl.is_contiguous()
        assert tl.shape == (B * h * w, h >> i, w >> i)
        assert not np.any(jl[:, :pad]) and not np.any(jl[:, -pad:])
        assert not np.any(jl[:, :, :pad]) and not np.any(jl[:, :, -pad:])
        got = t2n(tl)
        if i == 0:
            inner = jl[:, pad:-pad, pad:-pad]
            assert np.all(np.abs(got - inner) <= _bf16_ulp(np.maximum(np.abs(got), np.abs(inner))))
            assert np.mean(got == inner) > 0.99
        else:
            above = jnp.asarray(t2n(tpyr[i - 1]), jnp.bfloat16)[..., None]
            pooled = nn.avg_pool(above, (2, 2), strides=(2, 2))[..., 0]
            np.testing.assert_array_equal(got, np.asarray(pooled.astype(jnp.float32)))


def _coords(rng):
    """Coordinates (B, h, w, 2) at 1/8 resolution: in and off the frame, and
    at each level's clip bounds -(r+2) 2^i and (size + r + 1) 2^i of x and
    of y (exactly, and one float32 step either side)."""
    flat = rng.uniform(-8, 20, (B * h * w, 2)).astype(np.float32)
    q = 0
    for i in range(4):
        s = 2.0 ** i
        for k, size in ((0, w >> i), (1, h >> i)):
            for v in (-(4 + 2) * s, (size + 4 + 1) * s):
                v = np.float32(v)
                for u in (v, np.nextafter(v, np.float32(1e9)), np.nextafter(v, np.float32(-1e9))):
                    flat[q, k] = u
                    q += 1
    for v in (-40.0, 60.0, -0.5, 0.0, 3.0, 11.999):
        flat[q] = v
        q += 1
    return flat.reshape(B, h, w, 2)


@pytest.fixture(scope="module")
def pyramid():
    f1, f2 = _features(13)
    levels = traft.correlation_pyramid(_nchw(f1), _nchw(f2), 4)
    return levels, [np.pad(t2n(lv), ((0, 0), (11, 11), (11, 11))) for lv in levels]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lookup_plain_matches_jax(pyramid, dtype):
    levels, padded = pyramid
    coords = _coords(np.random.RandomState(14))
    dt = np.dtype(dtype)
    want = jraft.lookup_correlation(
        ([jnp.asarray(p, jnp.bfloat16 if dtype == "float32" else jnp.float64) for p in padded],
         11), jnp.asarray(coords.astype(dt)), 4)
    tl = levels if dtype == "float32" else [lv.double() for lv in levels]
    got = traft.lookup_correlation_plain(tl, torch.from_numpy(coords.astype(dt)), 4)
    assert got.shape == (B, h, w, 324) and got.dtype == getattr(torch, dtype)
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 if dtype == "float32" else 1e-12)


def test_lookup_channels_run_dx_major():
    """One non-zero value at level 1, (y, x) = (2, 5): a query at integer
    coordinates (x, y) = (2 * 3, 2 * 1) (level 1's (3, 1)) sees it at dx =
    5 - 3 + r, dy = 2 - 1 + r, channel 81 + dx * 9 + dy, with weight 1."""
    Q = B * h * w
    levels = [torch.zeros(Q, h >> i, w >> i, dtype=torch.bfloat16) for i in range(4)]
    levels[1][:, 2, 5] = 1.5
    coords = torch.zeros(B, h, w, 2)
    coords[..., 0], coords[..., 1] = 6.0, 2.0
    got = traft.lookup_correlation_plain(levels, coords, 4)
    want = torch.zeros(324)
    want[81 + (5 - 3 + 4) * 9 + (2 - 1 + 4)] = 1.5
    assert torch.equal(got[0, 0, 0], want)
    jgot = jraft.lookup_correlation(([jnp.asarray(np.pad(t2n(lv), ((0, 0), (11, 11), (11, 11))),
                                                  jnp.bfloat16) for lv in levels], 11),
                                    jnp.asarray(coords.numpy()), 4)
    np.testing.assert_array_equal(np.asarray(jgot)[0, 0, 0], want.numpy())


def test_lookup_function_takes_the_plain_version_on_the_cpu(pyramid):
    """`lookup_correlation` (through `RaftLookupFn`) on CPU tensors is the
    plain version cast to the network's dtype."""
    levels, _ = pyramid
    coords = torch.from_numpy(_coords(np.random.RandomState(15)))
    plain = traft.lookup_correlation_plain(levels, coords, 4)
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        got = traft.lookup_correlation(levels, coords, 4, dtype)
        assert got.dtype == dtype and torch.equal(got, plain.to(dtype))


FLOW_TOL = 2e-3     # px, at the full resolution


@pytest.fixture(scope="module")
def raft():
    rng = np.random.RandomState(16)
    pair = rng.uniform(-1, 1, (B, H, W, 6)).astype(np.float32)
    pair[..., 3:] = np.roll(pair[..., :3], (2, 3), axis=(1, 2)) + 0.05 * rng.randn(B, H, W, 3)
    jcfg = dataclasses.replace(JFlow(), raft_iters_eval=3, raft_iters_train=2)
    tcfg = dataclasses.replace(TFlow(), raft_iters_eval=3, raft_iters_train=2)
    jnet = jraft.RAFT(jcfg)
    variables = _vars(jnet, jnp.asarray(pair), seed=17)
    sd = weights.convert(variables, weights.raft_entries("", ""))
    tnet = load_strict(traft.RAFT(tcfg), sd).eval()
    return dict(pair=pair, jnet=jnet, variables=variables, sd=sd, tnet=tnet)


def test_raft_bridge_carries_every_leaf(raft):
    """Every flax leaf feeds a tensor of the port (the conv2d_cat kernels
    two each), and the upstream names are there."""
    leaves = jax.tree_util.tree_leaves(raft["variables"])
    n = sum(int(np.prod(x.shape)) for x in leaves)
    assert n == sum(int(v.numel()) for k, v in raft["sd"].items()
                    if not k.endswith("num_batches_tracked"))
    for key in ("fnet.conv1.weight", "fnet.norm1.weight", "fnet.layer2.0.downsample.1.bias",
                "cnet.layer3.0.downsample.1.running_var", "update_block.encoder.convc1.weight",
                "update_block.gru.convr2.bias", "update_block.flow_head.conv1.weight",
                "update_block.mask.0.weight", "update_block.mask.2.bias"):
        assert key in raft["sd"], key


def test_raft_eval_matches_jax(raft):
    jflow, jconf = jax.jit(raft["jnet"].apply)(raft["variables"], jnp.asarray(raft["pair"]))
    with torch.no_grad():
        tflow, tconf = raft["tnet"](torch.from_numpy(raft["pair"]))
    assert tflow.shape == (B, H, W, 2) and tflow.dtype == torch.float32
    assert tconf is None and jconf is None
    assert np.abs(np.asarray(jflow)).max() > 0.5
    np.testing.assert_allclose(t2n(tflow), np.asarray(jflow), rtol=0, atol=FLOW_TOL)


def test_raft_train_stack_matches_jax(raft):
    """The 2-iteration all_iters stack in train mode (cnet's BatchNorm on
    batch statistics, its running statistics moved by flax's rule)."""
    (jflows, _), upd = jax.jit(lambda v, p: raft["jnet"].apply(
        v, p, train=True, all_iters=True, mutable=["batch_stats"]))(
        raft["variables"], jnp.asarray(raft["pair"]))
    net = raft["tnet"]
    try:
        net.train()
        with torch.no_grad():
            tflows, tconf = net(torch.from_numpy(raft["pair"]), all_iters=True)
        stats = {k: t2n(getattr(net.cnet.norm1, k)).copy() for k in ("running_mean", "running_var")}
    finally:
        load_strict(net, raft["sd"]).eval()
    assert tflows.shape == (2, B, H, W, 2) and tconf is None
    np.testing.assert_allclose(t2n(tflows), np.asarray(jflows), rtol=0, atol=FLOW_TOL)
    jstats = upd["batch_stats"]["cnet"]["BatchNorm_0"]
    np.testing.assert_allclose(stats["running_mean"], np.asarray(jstats["mean"]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(stats["running_var"], np.asarray(jstats["var"]), rtol=1e-4)


def test_raft_refuses_sides_not_multiple_of_8(raft):
    with pytest.raises(ValueError, match="multiples of 8"):
        raft["tnet"](torch.zeros(1, 60, 96, 6))
