"""RAFT's lookup backward adding into one pyramid gradient across the
iterations (`models/raft.py::PyramidGrad`, kernel R2's accumulating plain
version `lookup_correlation_backward_accumulate_plain`), against the dense
gradients that autograd summed before.

- The accumulating plain backward over twelve lookups, last iteration
  first, from a zero fill, equals the dense plain backward's gradients
  added in the levels' dtype in that order, bit for bit (bf16 and float32
  levels; coordinates in and off the frame and on each level's clip
  bounds).
- A 2-iteration RAFT training step (64x96, b = 2, train mode, the
  `all_iters` stack under a sequence loss) through `PyramidGrad` gives the
  pyramid's and every parameter's gradient bit for bit as the dense path
  (each lookup returning its dense level gradients, autograd adding them).
  The float64 flow steps of `test_torch_train_raft_flow.py` hold this path
  to JAX.
- A second backward through the same graph gives the same gradients; a
  lookup out of order, and a pass that ends before lookup 0 hands the
  gradient over, raise.
"""

import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu_torch.config import SfMConfig
from deep_sfm_revisited_tpu_torch.models import raft as traft

torch.set_num_threads(2)
R, h, w = 4, 8, 12
Q = h * w
SHAPES = [(h >> i, w >> i) for i in range(4)]
ITERS = 12


def _coords(rng):
    flat = rng.uniform(-8, 20, (Q, 2)).astype(np.float32)
    q = 0
    for i, (hl, wl) in enumerate(SHAPES):
        for k, size in ((0, wl), (1, hl)):
            for v in (-(R + 2) * 2.0 ** i, (size + R + 1) * 2.0 ** i):
                flat[q, k] = v
                q += 1
    flat[q:q + 3] = [[-40.0, 60.0], [60.0, -40.0], [3.0, 2.0]]
    return torch.from_numpy(flat.reshape(1, h, w, 2))


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("level_dtype", [torch.bfloat16, torch.float32])
def test_accumulating_backward_is_the_dense_sum_in_the_levels_dtype(level_dtype):
    rng = np.random.RandomState(0)
    levels = [torch.from_numpy(rng.randn(Q, *s).astype(np.float32)).to(level_dtype)
              for s in SHAPES]
    calls = [(_coords(rng) + float(i) * 0.37, torch.from_numpy(
        rng.randn(1, h, w, 324).astype(np.float32)).to(torch.bfloat16)) for i in range(ITERS)]
    acc = [torch.zeros_like(lv) for lv in levels]
    dense = None
    for c, d in reversed(calls):                  # last iteration first
        dc = traft.lookup_correlation_backward_accumulate_plain(levels, c, d, R, acc)
        dl, wdc = traft.lookup_correlation_backward_plain(levels, c, d, R)
        assert torch.equal(dc, wdc)
        dense = dl if dense is None else [a + b for a, b in zip(dense, dl)]
    for i, (got, want) in enumerate(zip(acc, dense)):
        assert got.dtype == level_dtype and got.abs().max() > 0
        assert torch.equal(_bits(got), _bits(want)), f"level {i}"


class DenseLookupFn(torch.autograd.Function):
    """The lookup as the port ran it before: each call's backward returns
    the dense level gradients, which autograd adds."""

    @staticmethod
    def forward(ctx, coords, radius, out_dtype, acc, *levels):
        ctx.radius = radius
        ctx.save_for_backward(coords, *levels)
        return traft.lookup_correlation_plain(levels, coords, radius).to(out_dtype)

    @staticmethod
    def backward(ctx, dout):
        coords, *levels = ctx.saved_tensors
        dl, dc = traft.lookup_correlation_backward_plain(levels, coords, dout, ctx.radius)
        return (dc, None, None, None, *dl)


def _train_step(dtype):
    """Parameter and pyramid gradients of a 2-iteration RAFT step."""
    cfg = SfMConfig.kitti().override(**{"flow.estimator": "RAFT", "flow.raft_iters_train": 2})
    torch.manual_seed(0)
    net = traft.RAFT(cfg.flow).to(dtype).train()
    g = torch.Generator().manual_seed(1)
    pair = (torch.rand((2, 64, 96, 6), generator=g) * 2 - 1).to(dtype)
    gt = torch.randn((2, 64, 96, 2), generator=g, dtype=dtype) + 2
    pyramids = []
    real = traft.correlation_pyramid

    def keep(*a, **kw):
        levels = real(*a, **kw)
        for lv in levels:
            lv.retain_grad()
        pyramids.append(levels)
        return levels

    traft.correlation_pyramid = keep
    try:
        flows, _ = net(pair, all_iters=True)
    finally:
        traft.correlation_pyramid = real
    n = flows.shape[0]
    loss = sum(0.8 ** (n - i - 1) * (flows[i] - gt).abs().mean() for i in range(n))
    loss.backward()
    return ({k: p.grad for k, p in net.named_parameters()},
            [lv.grad for lv in pyramids[0]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_raft_step_gradients_are_the_dense_paths_bit_for_bit(dtype, monkeypatch):
    grads, pyr = _train_step(dtype)
    monkeypatch.setattr(traft, "RaftLookupFn", DenseLookupFn)
    want, wpyr = _train_step(dtype)
    assert set(grads) == set(want)
    for i, (a, b) in enumerate(zip(pyr, wpyr)):
        assert a.dtype == torch.bfloat16 and a.abs().max() > 0
        assert torch.equal(_bits(a), _bits(b)), f"pyramid level {i}"
    for k, v in grads.items():
        assert v.abs().max() > 0, k
        assert torch.equal(v, want[k]), k


def _chain(levels, coords, acc, n=3):
    outs, c = [], coords
    for _ in range(n):
        o = traft.lookup_correlation(levels, c, R, torch.bfloat16, acc)
        outs.append(o)
        c = c + 0.1 * o.float().mean(-1, keepdim=True)
    return sum((o.float() ** 2).sum() for o in outs) + c.sum()


def test_a_second_backward_through_the_graph_gives_the_same_gradients():
    rng = np.random.RandomState(2)
    levels = [torch.from_numpy(rng.randn(Q, *s).astype(np.float32)).to(torch.bfloat16)
              .requires_grad_() for s in SHAPES]
    coords = _coords(rng).requires_grad_()
    loss = _chain(levels, coords, traft.PyramidGrad())
    first = torch.autograd.grad(loss, [coords, *levels], retain_graph=True)
    second = torch.autograd.grad(loss, [coords, *levels])
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(g.abs().max() > 0 for g in first)


def test_lookups_out_of_order_or_a_pass_without_lookup_0_raise():
    levels = [torch.zeros(Q, *s, dtype=torch.bfloat16) for s in SHAPES]
    acc = traft.PyramidGrad()
    assert [acc.register() for _ in range(3)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="out of order"):
        # outside autograd's engine: no end-of-pass check to queue
        acc.grads, acc.last = [torch.zeros_like(lv) for lv in levels], 1
        acc.begin(2, levels)
    assert acc.grads is None
    rng = np.random.RandomState(3)
    lv = [t.clone().requires_grad_() for t in levels]
    acc = traft.PyramidGrad()
    traft.lookup_correlation(lv, _coords(rng), R, torch.float32, acc)
    second = traft.lookup_correlation(lv, _coords(rng) + 1, R, torch.float32, acc)
    with pytest.raises(RuntimeError, match="lookup 0"):
        torch.autograd.grad(second.sum(), lv)
    assert acc.grads is None
