"""RAFT's lookup backward (kernel R2's plain version) against `jax.vjp` of the
JAX package's `lookup_correlation`, its autograd function, and a numpy
replay of R1's and R2's work mapping.

- `models/raft.py::lookup_correlation_backward_plain` against the jitted
  `jax.vjp` of `lookup_correlation` on one pyramid (JAX's copy padded as
  JAX pads it; its gradient's interior is the port's), with coordinates on
  and off the frame, beyond the clip and exactly on each clip bound (where
  JAX's clip halves the gradient): in float64 (float64 coordinates and
  gradient, float64 levels holding bf16 values) to 1e-10, the levels'
  gradient included (JAX rounds the float32 patch's cotangent to float32
  term by term and adds the terms in float32 in its transpose's order,
  which the plain version follows); in float32 with a bf16 pyramid, the
  levels' gradient to one bf16 ulp (XLA may contract a product and a sum
  into one rounding before the cast) and the coordinates' to 1e-5 of its
  largest value (sums of 81 products in other orders).
- `RaftLookupFn` (through `lookup_correlation`) on CPU tensors: autograd
  gives the plain backward's gradients exactly, None where no gradient is
  wanted, and two lookups of one pyramid sum their level gradients.
- R1's and R2's mapping (`ops/cuda/raft_lookup.py::R1_QUERIES`, `R2_QUERIES`,
  `threads_a_query`, `row_words`, `unpack_row`, `owned_word`, `word_mode`,
  `store_units`) replayed in numpy with the kernels' index arithmetic,
  block by block and thread by thread (R1 a thread a window row of a level,
  R2 a thread a patch row; the tail block of a Q that is no multiple of the
  queries a block) at 9x13 (Q = 117; levels 9x13 and 1x1 of an odd size,
  so bf16 accumulators there go element by element) and at 8x12, 11x9 and
  8x10 with the levels one bf16 element off a 4-byte word (memory outside
  the tensor reads NaN): every output element computed once and stored once (16-byte
  units, then elements), every element of dout loaded once,
  every patch element on the level updated once (read-modify-write words
  at the patch's edges write their other element back unchanged); the
  window and the accumulated levels' gradient, replayed in float32 with
  the kernels' roundings, equal the plain versions' bit for bit, and the
  coordinates' gradient, replayed in float64, the plain version's in
  float64 to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2n

from deep_sfm_revisited_tpu.models import raft as jraft
from deep_sfm_revisited_tpu_torch.models import raft as traft
from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

torch.set_num_threads(1)
B, h, w, R, PAD = 1, 8, 12, 4, 11
Q = B * h * w
SHAPES = [(h >> i, w >> i) for i in range(4)]


def _coords(rng, dtype):
    """Coordinates (B, h, w, 2): in and off the frame, and at each level's
    clip bounds of x and y (exactly, and one step of `dtype` either side)."""
    flat = rng.uniform(-8, 20, (Q, 2)).astype(dtype)
    q = 0
    for i, (hl, wl) in enumerate(SHAPES):
        for k, size in ((0, wl), (1, hl)):
            for v in (-(R + 2) * 2.0 ** i, (size + R + 1) * 2.0 ** i):
                v = dtype(v)
                for u in (v, np.nextafter(v, dtype(1e9)), np.nextafter(v, dtype(-1e9))):
                    flat[q, k] = u
                    q += 1
    flat[q:q + 4] = np.array([[-40.0, 60.0], [60.0, -40.0], [0.0, 0.0], [3.5, 2.25]], dtype)
    return flat.reshape(B, h, w, 2)


def _levels(seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(Q, hl, wl).astype(np.float32)).to(torch.bfloat16)
            for hl, wl in SHAPES]


@pytest.fixture(scope="module")
def jax_vjp():
    def run(levels, coords, dout, dtype):
        padded = [jnp.asarray(np.pad(t2n(lv).astype(dtype), ((0, 0), (PAD, PAD), (PAD, PAD))),
                              jnp.bfloat16 if dtype == np.float32 else jnp.float64)
                  for lv in levels]

        @jax.jit
        def vjp(pyr, c, g):
            out, back = jax.vjp(lambda p, x: jraft.lookup_correlation((p, PAD), x, R), pyr, c)
            return out, back(g)

        out, (dpyr, dc) = vjp(padded, jnp.asarray(coords), jnp.asarray(dout))
        return (np.asarray(out), [np.asarray(d.astype(jnp.float64))[:, PAD:-PAD, PAD:-PAD]
                                  for d in dpyr], np.asarray(dc))
    return run


def test_plain_backward_matches_jax_vjp_float64(jax_vjp):
    rng = np.random.RandomState(1)
    levels = _levels(2)
    coords = _coords(rng, np.float64)
    dout = rng.randn(B, h, w, 324)
    _, jdl, jdc = jax_vjp(levels, coords, dout, np.float64)
    dl, dc = traft.lookup_correlation_backward_plain([lv.double() for lv in levels],
                                                     torch.from_numpy(coords),
                                                     torch.from_numpy(dout), R)
    assert dc.dtype == torch.float64 and dc.shape == (B, h, w, 2)
    for i, (got, want) in enumerate(zip(dl, jdl)):
        assert got.dtype == torch.float64 and got.shape == (Q, *SHAPES[i])
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10, err_msg=f"level {i}")
    assert np.abs(jdc).max() > 0.1
    np.testing.assert_allclose(dc.numpy(), jdc, rtol=0, atol=1e-10)
    # the clip's bounds: the halved gradient is there, and beyond the clip none
    flat, dflat = coords.reshape(-1, 2), jdc.reshape(-1, 2)
    far = np.abs(flat[:, 0]) >= 40
    assert np.all(dflat[far, 0] == 0)


def test_plain_backward_matches_jax_vjp_float32(jax_vjp):
    rng = np.random.RandomState(3)
    levels = _levels(4)
    coords = _coords(rng, np.float32)
    dout = rng.randn(B, h, w, 324).astype(np.float32)
    _, jdl, jdc = jax_vjp(levels, coords, dout, np.float32)
    dl, dc = traft.lookup_correlation_backward_plain(levels, torch.from_numpy(coords),
                                                     torch.from_numpy(dout), R)
    assert dc.dtype == torch.float32
    for i, (got, want) in enumerate(zip(dl, jdl)):
        assert got.dtype == torch.bfloat16
        got = t2n(got)
        big = np.maximum(np.abs(got), np.abs(want))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
        assert np.all(np.abs(got - want) <= ulp), f"level {i}"
        assert np.mean(got == want) > 0.9
    np.testing.assert_allclose(dc.numpy(), jdc, rtol=0, atol=1e-5 * np.abs(jdc).max())


def test_raft_lookup_fn_gradients_are_the_plain_backward():
    rng = np.random.RandomState(5)
    levels = [lv.requires_grad_() for lv in _levels(6)]
    coords = torch.from_numpy(_coords(rng, np.float32)).requires_grad_()
    dout = torch.from_numpy(rng.randn(B, h, w, 324).astype(np.float32))
    out = traft.lookup_correlation(levels, coords, R, torch.float32)
    grads = torch.autograd.grad(out, [coords, *levels], dout)
    dl, dc = traft.lookup_correlation_backward_plain([lv.detach() for lv in levels],
                                                     coords.detach(), dout, R)
    assert torch.equal(grads[0], dc)
    for got, want in zip(grads[1:], dl):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # a gradient only where one is wanted
    out = traft.lookup_correlation([lv.detach() for lv in levels], coords, R, torch.float32)
    (gc,) = torch.autograd.grad(out, [coords], dout)
    assert torch.equal(gc, dc)
    # two lookups of one pyramid (two iterations): the level gradients add
    # in the levels' dtype, as the transpose of JAX's scan adds them
    c2 = coords.detach() + 0.7
    two = (traft.lookup_correlation(levels, coords, R, torch.bfloat16).float() * dout).sum() + \
        (traft.lookup_correlation(levels, c2, R, torch.bfloat16).float() * dout).sum()
    g2 = torch.autograd.grad(two, levels)
    dl2, _ = traft.lookup_correlation_backward_plain([lv.detach() for lv in levels], c2,
                                                     dout.bfloat16(), R)
    dl1, _ = traft.lookup_correlation_backward_plain([lv.detach() for lv in levels],
                                                     coords.detach(), dout.bfloat16(), R)
    for got, a, b in zip(g2, dl1, dl2):
        assert torch.equal(got, a + b) or torch.equal(got, b + a)


def _window(v, size, scale, f):
    """The kernels' `make_window` for one coordinate in the float type f:
    the corner, fx, 1 - fx and clip'."""
    v = f(v) * f(scale)
    lo, hi = f(-(R + 2)), f(size + R + 1)
    mv = 1.0 if lo < v < hi else (0.5 if v in (lo, hi) else 0.0)
    t = f(min(max(v, lo), hi) - f(R))
    x0 = f(np.floor(t))
    fx = f(t - x0)
    return int(x0), fx, f(f(1) - fx), mv


def _round(v, itemsize):
    """float32 -> the levels' dtype (bf16 round to nearest even) -> float32."""
    v = np.float32(v)
    if itemsize == 4:
        return v
    return np.float32(torch.tensor(float(v)).to(torch.bfloat16).float().item())


BASE = 1 << 20      # the levels' and accumulators' simulated byte address


def _row(lv, q, Hl, Wl, yy, x0, itemsize, offset):
    """A patch row as a thread reads it (`row_words`, `unpack_row`), from
    the whole level `lv` (flat) starting `offset` bytes off a word; memory
    outside the tensor reads NaN, which the unpack must never keep."""
    E = 4 // itemsize
    base = BASE + offset + q * Hl * Wl * itemsize
    phase, addrs = raft_lookup.row_words(base, Hl, Wl, yy, x0, R, itemsize)
    halves = []
    for a in addrs:
        if a is None:
            halves.append([0.0] * E)
            continue
        assert a % 4 == 0
        el = (a - BASE - offset) // itemsize
        halves.append([float(lv[e]) if 0 <= e < lv.size else np.nan for e in range(el, el + E)])
    return np.array(raft_lookup.unpack_row(halves, phase, x0, Wl, R), np.float32)


def _replay(levels, coords, dout, acc, offset=0):
    """R1's and R2's work with their queries a block (`R1_QUERIES`,
    `R2_QUERIES`), block by block and thread by thread, with the kernels' index arithmetic and
    roundings (the window and d p in float32, the coordinates' gradient in
    float64). Levels start `offset` bytes off a 4-byte word, the
    accumulators `acc` (updated in place, numpy float32 holding the levels'
    dtype's values) on one. Returns (out, d coords) and how often each
    output, dout element and accumulator element was taken."""
    qpb1, qpb2 = raft_lookup.R1_QUERIES, raft_lookup.R2_QUERIES
    L, f32 = len(levels), np.float32
    itemsize = levels[0].element_size()
    shapes = [tuple(t.shape[1:]) for t in levels]
    S, D, K = 2 * R + 2, 2 * R + 1, (2 * R + 1) ** 2
    Q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    lv = [t2n(x).astype(np.float32).reshape(-1) for x in levels]
    flat = coords.reshape(Q, 2)
    out = np.zeros(Q * L * K, np.float32)
    out_n = np.zeros(Q * L * K, int)
    g_n = np.zeros(Q * L * K, int)
    acc_n = [np.zeros(a.size, int) for a in acc]
    dc = np.zeros((Q, 2))
    # R1: thread (query, level, window row dy) reads patch rows dy, dy + 1
    TQ = raft_lookup.threads_a_query(R)
    for q0 in range(0, Q, qpb1):
        nq = min(qpb1, Q - q0)
        stage = np.zeros(nq * L * K, np.float32)
        staged = np.zeros(nq * L * K, int)
        for tid in range(qpb1 * TQ):
            qi, l, dy = tid // TQ, tid % TQ // D, tid % TQ % D
            if qi >= nq or l >= L:
                continue
            q, (Hl, Wl) = q0 + qi, shapes[l]
            x0, fx, gx, _ = _window(flat[q, 0], Wl, 1.0 / (1 << l), f32)
            y0, fy, gy, _ = _window(flat[q, 1], Hl, 1.0 / (1 << l), f32)
            a = _row(lv[l], q, Hl, Wl, y0 + dy, x0, itemsize, offset)
            b = _row(lv[l], q, Hl, Wl, y0 + dy + 1, x0, itemsize, offset)
            w00, w01, w10, w11 = f32(gy * gx), f32(gy * fx), f32(fy * gx), f32(fy * fx)
            v = f32(f32(f32(w00 * a[:-1]) + f32(w01 * a[1:])) + f32(w10 * b[:-1]))
            v = f32(v + f32(w11 * b[1:]))                          # over dx
            at = (qi * L + l) * K + np.arange(D) * D + dy
            stage[at] = v
            staged[at] += 1
        assert np.all(staged == 1)
        for tid in range(qpb1 * TQ):
            for b_, e in raft_lookup.store_units(nq * L * K, 4, tid, qpb1 * TQ):
                out[q0 * L * K + b_:q0 * L * K + e] = stage[b_:e]
                out_n[q0 * L * K + b_:q0 * L * K + e] += 1
    # R2: thread (query, level, patch row s)
    TQ = raft_lookup.threads_a_query(R, backward=True)
    g_all = dout.reshape(-1)
    for q0 in range(0, Q, qpb2):
        nq = min(qpb2, Q - q0)
        for tid in range(qpb2 * TQ):
            for b_, e in raft_lookup.store_units(nq * L * K, 4, tid, qpb2 * TQ):
                g_n[q0 * L * K + b_:q0 * L * K + e] += 1
        dps = {}
        for tid in range(qpb2 * TQ):
            qi, l, s_ = tid // TQ, tid % TQ // S, tid % TQ % S
            if qi >= nq or l >= L:
                continue
            q, (Hl, Wl) = q0 + qi, shapes[l]
            gl = g_all[(q * L + l) * K:(q * L + l + 1) * K].reshape(D, D)   # [dx, dy]
            x0, fx, gx, _ = _window(flat[q, 0], Wl, 1.0 / (1 << l), f32)
            y0, fy, gy, _ = _window(flat[q, 1], Hl, 1.0 / (1 << l), f32)
            w00, w01, w10, w11 = f32(gy * gx), f32(gy * fx), f32(fy * gx), f32(fy * fx)
            row = np.zeros(S, np.float32)
            for t in range(S):
                a = f32(0)
                if s_ >= 1 and t >= 1:
                    a = f32(a + f32(w11 * gl[t - 1, s_ - 1]))
                if s_ >= 1 and t < D:
                    a = f32(a + f32(w10 * gl[t, s_ - 1]))
                if s_ < D and t >= 1:
                    a = f32(a + f32(w01 * gl[t - 1, s_]))
                if s_ < D and t < D:
                    a = f32(a + f32(w00 * gl[t, s_]))
                row[t] = _round(a, itemsize)
            dps.setdefault((qi, l), np.zeros(S * S, np.float32))[s_ * S:(s_ + 1) * S] = row
        for tid in range(qpb2 * TQ):
            qi, l, s_ = tid // TQ, tid % TQ // S, tid % TQ % S
            if qi >= nq or l >= L:
                continue
            q, (Hl, Wl) = q0 + qi, shapes[l]
            x0, _, _, _ = _window(flat[q, 0], Wl, 1.0 / (1 << l), f32)
            y0, _, _, _ = _window(flat[q, 1], Hl, 1.0 / (1 << l), f32)
            dp = dps[qi, l]
            gb = BASE + q * Hl * Wl * itemsize
            if raft_lookup.word_mode(BASE, Hl, Wl, itemsize):
                for j in range(raft_lookup.words_a_row(R, itemsize)):
                    own, addr, slots = raft_lookup.owned_word(gb, Hl, Wl, y0, x0, s_, j, R,
                                                              itemsize)
                    if not own:
                        continue
                    for hh, sl in enumerate(slots):
                        el = (addr - BASE) // itemsize + hh
                        if sl >= 0:
                            acc[l][el] = _round(f32(acc[l][el] + dp[sl]), itemsize)
                            acc_n[l][el] += 1
            else:
                yy = y0 + s_
                for t in range(S):
                    xx = x0 + t
                    if 0 <= yy < Hl and 0 <= xx < Wl:
                        el = (q * Hl + yy) * Wl + xx
                        acc[l][el] = _round(f32(acc[l][el] + dp[s_ * S + t]), itemsize)
                        acc_n[l][el] += 1
        # the coordinates' gradient, in float64 (its window's corner can differ
        # from float32's where x - r rounds to an integer): each window row's
        # sums over dx, rows in dy order, levels in order
        for qi in range(nq):
            q = q0 + qi
            for l in range(L):
                Hl, Wl = shapes[l]
                scale = 1.0 / (1 << l)
                x0, fx, gx, mx = _window(flat[q, 0], Wl, scale, np.float64)
                y0, fy, gy, my = _window(flat[q, 1], Hl, scale, np.float64)
                p = np.stack([_row(lv[l], q, Hl, Wl, y0 + r, x0, itemsize, offset)
                              for r in range(S)]).astype(np.float64)
                g64 = g_all[(q * L + l) * K:(q * L + l + 1) * K].reshape(D, D).T.astype(
                    np.float64)                                         # [dy, dx]
                s00, s01, s10, s11 = ((g64 * p[a_:a_ + D, b_:b_ + D]).sum()
                                      for a_, b_ in ((0, 0), (0, 1), (1, 0), (1, 1)))
                dc[q] += ((s01 * gy + s11 * fy - (s00 * gy + s10 * fy)) * mx * scale,
                          (s10 * gx + s11 * fx - (s00 * gx + s01 * fx)) * my * scale)
    return out, dc, out_n, g_n, acc_n


def _replay_inputs(seed, hh, ww, level_dtype):
    rng = np.random.RandomState(seed)
    Qr = hh * ww
    shapes = [(hh >> i, ww >> i) for i in range(4)]
    levels = [torch.from_numpy(rng.randn(Qr, a, b).astype(np.float32)).to(level_dtype)
              for a, b in shapes]
    flat = rng.uniform(-8, ww + 8, (Qr, 2)).astype(np.float32)
    q = 0
    for i, (a, b) in enumerate(shapes):     # each level's clip bounds, and beyond
        for k, size in ((0, b), (1, a)):
            for v in (-(R + 2) * 2.0 ** i, (size + R + 1) * 2.0 ** i):
                flat[q, k] = v
                q += 1
    flat[q:q + 3] = [[-40.0, 60.0], [60.0, -40.0], [0.0, 0.0]]
    coords = flat.reshape(1, hh, ww, 2)
    dout = rng.randn(Qr, 4 * 81).astype(np.float32)
    acc = [t2n(torch.from_numpy(rng.randn(*t.shape).astype(np.float32)).to(level_dtype))
           .reshape(-1).astype(np.float32) for t in levels]
    return levels, coords, dout, acc


@pytest.mark.parametrize("level_dtype", [torch.bfloat16, torch.float32])
def test_kernel_mapping_replay_covers_and_matches_the_plain_versions(level_dtype):
    """The kernels' mappings at 9x13 (Q = 117: a tail block; levels 9x13 and
    1x1 of odd size): every tap staged once, every output and dout element
    moved once, every patch element on the level updated once; the window
    bit for bit the plain version's, the accumulators bit for bit the
    accumulating plain version's from the same start (in the levels'
    dtype), the coordinates' gradient to 1e-10 of the plain version in
    float64."""
    levels, coords, dout, acc = _replay_inputs(9, 9, 13, level_dtype)
    start = [a.copy() for a in acc]
    assert 117 % raft_lookup.R1_QUERIES and 117 % raft_lookup.R2_QUERIES
    out, dc, out_n, g_n, acc_n = _replay(levels, coords, dout, acc)
    assert np.all(out_n == 1) and np.all(g_n == 1)
    ct = torch.from_numpy(coords)
    want = traft.lookup_correlation_plain(levels, ct, R)
    np.testing.assert_array_equal(out, want.reshape(-1).numpy())
    wacc = [torch.from_numpy(a).reshape(t.shape).to(level_dtype) for a, t in zip(start, levels)]
    g = torch.from_numpy(dout.reshape(1, 9, 13, -1))
    traft.lookup_correlation_backward_accumulate_plain(levels, ct, g, R, wacc)
    for i, (got, w, n) in enumerate(zip(acc, wacc, acc_n)):
        np.testing.assert_array_equal(got, t2n(w).reshape(-1), err_msg=f"level {i}")
        # each element under a query's patch on the level, once
        onpatch = traft.lookup_correlation_backward_plain(
            levels, ct, torch.ones_like(g), R)[0][i].reshape(-1) != 0
        assert np.all(n[onpatch.numpy()] == 1) and np.all(n[~onpatch.numpy()] <= 1)
    _, wdc = traft.lookup_correlation_backward_plain(
        levels, torch.from_numpy(coords.astype(np.float64)), g.double(), R)
    np.testing.assert_allclose(dc, wdc.reshape(-1, 2).numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("hw", [(8, 12), (11, 9), (8, 10)])
def test_levels_off_a_word_replay_covers_and_matches_the_plain_versions(hw):
    """The bf16 levels starting one element off a 4-byte word (every row's
    phase flips), at 8x12 (Q = 96: whole blocks), 11x9 (Q = 99: a tail
    block for both kernels; levels 11x9 and 1x1 of odd size, updated
    element by element) and 8x10 (Q = 80; a tail block in neither): as
    above."""
    hh, ww = hw
    levels, coords, dout, acc = _replay_inputs(10, hh, ww, torch.bfloat16)
    start = [a.copy() for a in acc]
    out, dc, out_n, g_n, acc_n = _replay(levels, coords, dout, acc, offset=2)
    assert np.all(out_n == 1) and np.all(g_n == 1)
    ct = torch.from_numpy(coords)
    np.testing.assert_array_equal(out, traft.lookup_correlation_plain(levels, ct, R)
                                  .reshape(-1).numpy())
    wacc = [torch.from_numpy(a).reshape(t.shape).to(torch.bfloat16)
            for a, t in zip(start, levels)]
    g = torch.from_numpy(dout.reshape(1, hh, ww, -1))
    traft.lookup_correlation_backward_accumulate_plain(levels, ct, g, R, wacc)
    for got, w in zip(acc, wacc):
        np.testing.assert_array_equal(got, t2n(w).reshape(-1))
    _, wdc = traft.lookup_correlation_backward_plain(
        levels, torch.from_numpy(coords.astype(np.float64)), g.double(), R)
    np.testing.assert_allclose(dc, wdc.reshape(-1, 2).numpy(), rtol=0, atol=1e-10)


def test_grad_row_units_split_rows_as_the_kernel_does():
    """The kernels' units: a block's span in 16-byte units (8 bf16, 4
    float32 elements) then single elements, all elements where the span is
    not aligned; tap words of a bf16 row at both phases; accumulator words
    at the patch's edges (the element outside written back unchanged, a
    word across two rows taken by the upper row's lane), and element by
    element where a query's rows do not start on a word."""
    su = raft_lookup.store_units
    assert su(20, 2, 0, 1) == [(0, 8), (8, 16), (16, 17), (17, 18), (18, 19), (19, 20)]
    assert su(20, 2, 1, 2) == [(8, 16), (17, 18), (19, 20)]
    assert su(13, 4, 0, 8) == [(0, 4), (12, 13)]
    assert su(5, 2, 0, 1, aligned=False) == [(e, e + 1) for e in range(5)]
    # 8 queries of 324 bf16 values: 324 units of 16 bytes, no tail
    assert sum(len(su(8 * 324, 2, t, 256)) for t in range(256)) == 324
    # a bf16 row at x0 = 3 of a level 20 wide: phase 1, word 0 holds columns -1, 0
    assert raft_lookup.row_word(0, 0, 3, 20, 0, 2) == (4, -1)
    assert raft_lookup.row_word(0, 0, 4, 20, 5, 2) == (28, 10)
    assert raft_lookup.row_words(0, 6, 20, 0, 3, R, 2) == (1, [4, 8, 12, 16, 20, 24])
    # x0 = -5: columns -6.. -1 of words 0 and 1 lie off the level (not read)
    assert raft_lookup.row_words(0, 6, 20, 1, -5, R, 2) == (1, [None, None, None, 40, 44, 48])
    assert raft_lookup.row_words(0, 6, 20, 6, 3, R, 2)[1] == [None] * 6      # below the level
    # phase 1: the words' halves shift by one; columns off the level read 0
    halves = [[9.0, 0.0], [1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0], [9.0, 10.0]]
    assert raft_lookup.unpack_row(halves, 1, 0, 20, R) == [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]
    assert raft_lookup.unpack_row(halves, 0, -1, 8, R) == [0, 0, 1, 2, 3, 4, 5, 6, 7, 0]
    # the patch's left edge at column 3: word (2, 3) updates column 3 only
    assert raft_lookup.owned_word(0, 6, 20, 0, 3, 0, 0, R, 2) == (True, 4, [-1, 0])
    # a level 5 wide (whole rows under the patch): the word holding row 0's
    # column 4 and row 1's column 0 is row 0's lane's (its word 3), not row
    # 1's (its word 1)
    assert raft_lookup.owned_word(0, 4, 5, 0, -2, 0, 3, R, 2) == (True, 8, [6, 12])
    assert raft_lookup.owned_word(0, 4, 5, 0, -2, 1, 1, R, 2) == (False, 8, [-1, 12])
    assert raft_lookup.word_mode(0, 9, 13, 2) is False and raft_lookup.word_mode(2, 4, 6, 2) is False
    assert raft_lookup.word_mode(0, 4, 6, 2) and raft_lookup.word_mode(0, 9, 13, 4)
