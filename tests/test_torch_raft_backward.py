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
- R1's and R2's mapping (`ops/cuda/raft_lookup.py::mapping`,
  `grad_row_units`) replayed in numpy with the kernels' index arithmetic:
  every (query, level, channel), every patch tap and every element of
  every level's gradient is taken exactly once; the window and the levels'
  gradient, replayed in float32 with the kernels' roundings, equal the
  plain versions' bit for bit, and the coordinates' gradient, replayed in
  float64, the plain version's in float64 to 1e-10.
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
    """The kernels' `Window` for one coordinate in the float type f: the
    corner, fx, 1 - fx and clip'."""
    v = f(v) * f(scale)
    lo, hi = f(-(R + 2)), f(size + R + 1)
    mv = 1.0 if lo < v < hi else (0.5 if v in (lo, hi) else 0.0)
    t = f(min(max(v, lo), hi) - f(R))
    x0 = f(np.floor(t))
    fx = f(t - x0)
    return int(x0), fx, f(f(1) - fx), mv


def _replay(levels, coords, dout):
    """R1's and R2's work, block by block and lane by lane, with the
    kernels' index arithmetic. The window, the blend and the patch
    gradient in float32, each operation rounded as the kernels round it
    (`__fmul_rn`, `__fadd_rn`); the coordinates' gradient in float64.
    Returns (out, d levels, d coords) and how often each output, staged
    tap and gradient element was taken."""
    L, f32 = len(levels), np.float32
    itemsize = levels[0].element_size()
    m = raft_lookup.mapping(Q, L, R)
    S, D, K = 2 * R + 2, 2 * R + 1, (2 * R + 1) ** 2
    assert m.grid == Q and m.block == (32, L) and m.patch == S * S and m.channels == K
    lv = [t2n(x) for x in levels]
    flat = coords.reshape(Q, 2)
    out = np.zeros((Q, L * K), np.float32)
    out_n = np.zeros((Q, L * K), int)
    dl = [np.zeros((Q, hl * wl), np.float32) for hl, wl in SHAPES]
    dl_n = [np.zeros((Q, hl * wl), int) for hl, wl in SHAPES]
    dc = np.zeros((Q, 2))
    for q in range(m.grid):
        dpatches, corners = [], []
        for l in range(L):
            Hl, Wl = SHAPES[l]
            scale = 1.0 / (1 << l)
            x0, fx, gx, mx = _window(flat[q, 0], Wl, scale, f32)
            y0, fy, gy, my = _window(flat[q, 1], Hl, scale, f32)
            patch = np.zeros(S * S, np.float32)
            staged = np.zeros(S * S, int)
            for lane in range(32):
                for k in m.lane_items(lane, S * S):
                    s, t = k // S, k - (k // S) * S
                    yy, xx = y0 + s, x0 + t
                    staged[k] += 1
                    if 0 <= yy < Hl and 0 <= xx < Wl:
                        patch[k] = lv[l][q, yy, xx]
            assert np.all(staged == 1)
            w00, w01, w10, w11 = f32(gy * gx), f32(gy * fx), f32(fy * gx), f32(fy * fx)
            g = dout[q, l * K:(l + 1) * K]
            for lane in range(32):
                for c in m.lane_items(lane, K):
                    dx = c // D
                    dy = c - dx * D
                    p = dy * S + dx
                    v = f32(f32(w00 * patch[p]) + f32(w01 * patch[p + 1]))
                    v = f32(v + f32(w10 * patch[p + S]))
                    out[q, l * K + c] = f32(v + f32(w11 * patch[p + S + 1]))
                    out_n[q, l * K + c] += 1
            dpatch = np.zeros(S * S, np.float32)
            for lane in range(32):
                for k in m.lane_items(lane, S * S):
                    s, t = k // S, k - (k // S) * S
                    acc = f32(0)
                    if s >= 1 and t >= 1:
                        acc = f32(acc + f32(w11 * g[(t - 1) * D + s - 1]))
                    if s >= 1 and t < D:
                        acc = f32(acc + f32(w10 * g[t * D + s - 1]))
                    if s < D and t >= 1:
                        acc = f32(acc + f32(w01 * g[(t - 1) * D + s]))
                    if s < D and t < D:
                        acc = f32(acc + f32(w00 * g[t * D + s]))
                    dpatch[k] = acc
            dpatches.append(dpatch)
            corners.append((y0, x0))
            # the coordinates' gradient, in float64 (its window's corner can
            # differ from float32's where x - r rounds to an integer)
            x0, fx, gx, _ = _window(flat[q, 0], Wl, scale, np.float64)
            y0, fy, gy, _ = _window(flat[q, 1], Hl, scale, np.float64)
            patch = np.zeros(S * S)
            for lane in range(32):
                for k in m.lane_items(lane, S * S):
                    yy, xx = y0 + k // S, x0 + k % S
                    if 0 <= yy < Hl and 0 <= xx < Wl:
                        patch[k] = lv[l][q, yy, xx]
            sums = np.zeros(4)
            for lane in range(32):
                for c in m.lane_items(lane, K):
                    dx = c // D
                    p = (c - dx * D) * S + dx
                    sums += float(g[c]) * patch[[p, p + 1, p + S, p + S + 1]]
            s00, s01, s10, s11 = sums
            dc[q] += ((s01 * gy + s11 * fy - (s00 * gy + s10 * fy)) * mx * scale,
                      (s10 * gx + s11 * fx - (s00 * gx + s01 * fx)) * my * scale)
        for mm in range(L):
            Hl, Wl = SHAPES[mm]
            for tid in range(32 * L):
                for b, e in raft_lookup.grad_row_units(Hl * Wl, itemsize, tid, 32 * L):
                    for el in range(b, e):
                        yy, xx = el // Wl, el - (el // Wl) * Wl
                        s, t = yy - corners[mm][0], xx - corners[mm][1]
                        inside = 0 <= s < S and 0 <= t < S
                        dl[mm][q, el] = dpatches[mm][s * S + t] if inside else 0.0
                        dl_n[mm][q, el] += 1
    return out, dl, dc, out_n, dl_n


@pytest.mark.parametrize("level_dtype", [torch.bfloat16, torch.float32])
def test_kernel_mapping_replay_covers_and_matches_the_plain_versions(level_dtype):
    """Every (query, level, channel), tap and gradient element once; the
    window and the levels' gradient bit for bit the plain versions' (in
    the levels' dtype: 16-byte units of 8 bf16 or 4 float32 elements, and
    single elements for the rows of 6 and 1), the coordinates' gradient to
    1e-10 of the plain version in float64."""
    rng = np.random.RandomState(7)
    levels = [lv.to(level_dtype) for lv in _levels(8)]
    coords = _coords(rng, np.float32)
    dout = rng.randn(Q, 324).astype(np.float32)
    out, dl, dc, out_n, dl_n = _replay(levels, coords, dout)
    assert np.all(out_n == 1)
    for n in dl_n:
        assert np.all(n == 1)
    want = traft.lookup_correlation_plain(levels, torch.from_numpy(coords), R)
    np.testing.assert_array_equal(out, want.reshape(Q, -1).numpy())
    g = torch.from_numpy(dout.reshape(B, h, w, -1))
    wdl, _ = traft.lookup_correlation_backward_plain(levels, torch.from_numpy(coords), g, R)
    for got, want_l in zip(dl, wdl):
        assert want_l.dtype == level_dtype
        np.testing.assert_array_equal(torch.from_numpy(got).to(level_dtype).float().numpy(),
                                      t2n(want_l).reshape(Q, -1))
    _, wdc = traft.lookup_correlation_backward_plain(
        levels, torch.from_numpy(coords.astype(np.float64)), g.double(), R)
    np.testing.assert_allclose(dc, wdc.reshape(Q, 2).numpy(), rtol=0, atol=1e-10)


def test_grad_row_units_split_rows_as_the_kernel_does():
    """16-byte units where the row is a whole number of them (8 bf16, 4
    float32 elements), single elements otherwise or where not aligned."""
    assert raft_lookup.grad_row_units(96, 2, 1, 128) == [(8, 16)]
    assert raft_lookup.grad_row_units(96, 4, 130, 128) == []
    assert raft_lookup.grad_row_units(96, 4, 2, 128) == [(8, 12)]
    assert raft_lookup.grad_row_units(6, 2, 5, 128) == [(5, 6)]
    assert raft_lookup.grad_row_units(16, 2, 0, 1, aligned=False) == [(e, e + 1)
                                                                     for e in range(16)]
