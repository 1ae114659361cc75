"""The correlations' backward kernels' work mapping, replayed on the CPU.

`ops/cuda/local_corr.py::backward_plan` picks the mapping that
`csrc/warped_corr_backward.cu` launches with (a tile x channel-group grid,
the groups of a tile one cluster where there is a flow). The card runs the
kernel itself (`tests/test_torch_cuda.py`, `chip_smoke.py`); here its index
arithmetic is replayed in numpy float64: the blocks of the grid, each
block's two dout stagings (g[q - d, d], then g[p, d]), its halo units at
their pitch, each thread's run of pixels and slot of channels in the
register-tiled sums, the owners' blends with d f2's scatter and d flow's
terms, and the clusters' rank-order d-flow sum. The replay is held to the
plain backwards (`ops/correlation.py::local_correlation_backward_plain`,
`warped_correlation_nchw_backward_plain`) at 1e-10 of each gradient's
largest element; every element it writes is written once.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu_torch.ops import correlation as tcorr
from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr as lc

torch.set_num_threads(2)
SOURCE = Path(lc.__file__).resolve().parents[2] / "csrc" / "warped_corr_backward.cu"
# PWC-DC's correlations at a b = 4, 256x768 training step (B2's level 6,
# float32, then the warped levels 5..2) and at phase 20's b = 2, 128x128
# step: (B, C, H, W), dtype, flow
LEVELS = ([((4, 196, 4, 12), torch.float32, False)]
          + [((4, c, h, w), d, True) for c, h, w in ((128, 8, 24), (96, 16, 48), (64, 32, 96),
                                                     (32, 64, 192))
             for d in (torch.bfloat16, torch.float32)]
          + [((2, 196, 2, 2), torch.float32, False)]
          + [((2, c, s, s), d, True) for c, s in ((128, 4), (96, 8), (64, 16), (32, 32))
             for d in (torch.bfloat16, torch.float32)])
# ragged: H, W no multiples of any tile, C no multiple of a slot
RAGGED = [((2, 21, 7, 13), torch.float32, False), ((1, 3, 5, 7), torch.float32, False),
          ((2, 40, 13, 27), torch.bfloat16, True), ((1, 3, 5, 7), torch.float32, True),
          ((1, 20, 9, 10), torch.bfloat16, True)]


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    return int(m.group(1))


def test_plan_constants_are_the_kernels():
    assert (lc.BWD_SLOT, lc.BWD_MAX_THREADS, lc.BWD_SMEM_MAX, lc.MAX_CLUSTER) == tuple(
        _constant(n) for n in ("kSlot", "kMaxThreads", "kSmemMax", "kMaxCluster"))
    runs = re.search(r"cudaError_t by_run\(int run.*?default", SOURCE.read_text(), re.S).group(0)
    assert tuple(int(r) for r in re.findall(r"case (\d+):", runs)) == lc.BWD_RUNS


@pytest.mark.parametrize("md", [1, 4])
@pytest.mark.parametrize("shape,dtype,flow", LEVELS + RAGGED)
def test_backward_plan_is_valid(shape, dtype, flow, md):
    """`backward_plan`'s mapping fits the kernel: shared memory within a
    block's 227 KB, at most 512 threads, a tile width a multiple of the
    run, channel groups that cover C once, with a flow one cluster of at
    most 8 ranks a tile; and every mapping of the grid is too."""
    B, C, H, W = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    p = lc.backward_plan(B, C, H, W, md, dtype, flow)
    grid = lc.backward_mappings(B, C, H, W, md, itemsize, flow)
    assert p in grid or lc.backward_mapping(B, C, H, W, md, itemsize, flow, p.tile_h, p.tile_w,
                                            p.run, p.slots) == p
    for q in grid + [p]:
        assert q.smem == lc.backward_smem(md, itemsize, flow, q.tile_h, q.tile_w, q.slots)
        assert q.smem <= lc.BWD_SMEM_MAX and q.threads <= lc.BWD_MAX_THREADS
        assert q.run in lc.BWD_RUNS and q.tile_w % q.run == 0
        assert q.threads == q.tile_h * q.tile_w // q.run * q.slots
        assert q.slots & (q.slots - 1) == 0
        assert (q.groups - 1) * q.slots * lc.BWD_SLOT < C <= q.groups * q.slots * lc.BWD_SLOT
        assert q.cluster == (q.groups if flow else 1) and q.cluster <= lc.MAX_CLUSTER
        assert q.grid == (-(-W // q.tile_w) * q.groups, -(-H // q.tile_h), B)


def _taps(flow_b, scale, gy, gx, H, W):
    """B1's rule at pixels (gy, gx) of one image, in float32 as the kernel's
    `pixel_taps` and `Taps` compute it: tap (0, 0), the +1 taps' presence,
    the weights, validity and the edge factors of d flow."""
    f32 = np.float32
    x = gx.astype(f32) + flow_b[0, gy, gx] * f32(scale)
    y = gy.astype(f32) + flow_b[1, gy, gx] * f32(scale)
    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    xc, yc = np.clip(x, f32(0), f32(W - 1)), np.clip(y, f32(0), f32(H - 1))
    x0, y0 = np.floor(xc), np.floor(yc)
    wx, wy = (xc - x0).astype(f32), (yc - y0).astype(f32)
    xi = np.clip(x0.astype(np.int64), 0, W - 1)
    yi = np.clip(y0.astype(np.int64), 0, H - 1)
    hx, hy = np.minimum(xi + 1, W - 1) - xi, np.minimum(yi + 1, H - 1) - yi
    ex = np.where(x == 0, 0.5, 1.0) * np.where(x == W - 1, 0.5, 1.0)
    ey = np.where(y == 0, 0.5, 1.0) * np.where(y == H - 1, 0.5, 1.0)
    return dict(yi=yi, xi=xi, hx=hx, hy=hy, wx=wx, wy=wy, ax=(f32(1) - wx).astype(f32),
                ay=(f32(1) - wy).astype(f32), valid=valid, ex=ex.astype(f32), ey=ey.astype(f32))


def _replay(f1, f2, flow, scale, dout, md, p, itemsize):
    """The kernel's work on f1, f2 (B, H, W, C) float64, an optional flow
    (B, 2, H, W) float32 and dout (B, H, W, LD) float64 whose first
    (2md+1)^2 channels are the gradient (LD larger: a channel slice, read at
    its pixel stride), under mapping `p` with the index arithmetic of a
    `itemsize`-byte feature type. Returns (d f1, d f2, d flow) and checks
    that every staged value and output is written once."""
    B, H, W, C = f1.shape
    S = 2 * md + 1
    S2 = S * S
    E, QS = 16 // itemsize, lc.BWD_SLOT * itemsize // 16
    GP = S2 + (1 if itemsize == 2 and S2 % 2 else 0)
    TH, TW, NS, G, R = p.tile_h, p.tile_w, p.slots, p.groups, p.run
    NR, threads = TW // R, p.threads
    hh, hw, Q = TH + 2 * md, TW + 2 * md, NS * QS
    qp, npix, nhalo = Q | 1, TH * TW, hh * hw
    assert p.smem == lc.backward_smem(md, itemsize, flow is not None, TH, TW, NS)
    tid = np.arange(threads)
    s, run, row = tid % NS, (tid // NS) % NR, tid // (NS * NR)
    assert len(set(zip(s, run, row))) == threads and (row < TH).all()
    df1 = np.zeros_like(f1)
    df2 = np.zeros_like(f2)
    dflow = np.zeros((B, 2, H, W), np.float32)
    wrote = {k: np.zeros((B, H, W) + (() if k == "dflow" else (C,)), np.int64)
             for k in ("df1", "df2", "dflow")}
    tiles_x, tiles_y = p.grid[0] // G, p.grid[1]
    assert p.grid == (-(-W // TW) * G, -(-H // TH), B)
    for b in range(B):
        for by in range(tiles_y):
            for tx in range(tiles_x):
                blks, taps_of = [], None
                for bx in range(tx * G, tx * G + G):   # the tile's cluster, rank = group
                    group, x0, y0 = bx % G, (bx // G) * TW, by * TH
                    cb = group * NS * lc.BWD_SLOT
                    c0 = cb + s * lc.BWD_SLOT
                    y = y0 + row
                    hp_all = np.arange(nhalo)
                    gy_h, gx_h = y0 - md + hp_all // hw, x0 - md + hp_all % hw
                    in_h = (gy_h >= 0) & (gy_h < H) & (gx_h >= 0) & (gx_h < W)
                    if flow is not None:
                        taps = _taps(flow[b], scale, gy_h.clip(0, H - 1), gx_h.clip(0, W - 1),
                                     H, W)
                        taps["valid"] &= in_h
                        taps_of = taps

                    # the kernel's index tables: each halo pixel's index in the
                    # frame (or -1), each tile pixel's index in the halo (or -1)
                    frame = np.where(in_h, gy_h.clip(0, H - 1) * W + gx_h.clip(0, W - 1), -1)
                    qq = np.arange(npix)
                    inhalo = np.where((y0 + qq // TW < H) & (x0 + qq % TW < W),
                                      (qq // TW + md) * hw + qq % TW + md, -1)
                    flat = dout[b].reshape(H * W, -1)

                    def stage_g(shifted):
                        i = np.arange(npix * S2)
                        q, d = i // S2, i % S2
                        h = inhalo[q]
                        src = h + (md - d // S) * hw + md - d % S if shifted else h
                        o = np.where(h >= 0, frame[src.clip(0, nhalo - 1)], -1)
                        gs = np.full(npix * GP, np.nan)
                        gs[q * GP + d] = np.where(o >= 0, flat[o.clip(0), d], 0.0)
                        assert np.isnan(gs.reshape(npix, GP)[:, S2:]).all()
                        return np.nan_to_num(gs)

                    def units(img, hp, u):
                        """Unit u (E channels from cb + u E) of halo pixels hp."""
                        c = cb + u * E
                        gy, gx = y0 - md + hp // hw, x0 - md + hp % hw
                        ok = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
                        out = np.zeros((len(hp), E))
                        for e in range(E):
                            m = ok & (c + e < C)
                            out[m, e] = img[b, gy[m], gx[m], c[m] + e]
                        return out

                    def sums(halo, gs, d_f1):
                        acc = np.zeros((threads, R, lc.BWD_SLOT))
                        for dy in range(S):
                            hr = row + dy if d_f1 else row + 2 * md - dy
                            base = (hr * hw + run * R) * qp + s * QS
                            for jj in range(R + 2 * md):
                                j = jj if d_f1 else R + 2 * md - 1 - jj
                                v = np.concatenate([halo[base + j * qp + t] for t in range(QS)],
                                                   axis=1)
                                for i in range(R):
                                    dx = j - i if d_f1 else i + 2 * md - j
                                    if 0 <= dx <= 2 * md:
                                        g = gs[(row * TW + run * R + i) * GP + dy * S + dx]
                                        acc[:, i] += g[:, None] * v
                        return acc / C

                    def store(out, key, a):
                        for i in range(R):
                            x = x0 + run * R + i
                            for k in range(lc.BWD_SLOT):
                                c = c0 + k
                                m = (y < H) & (x < W) & (c < C)
                                out[b, y[m], x[m], c[m]] = a[m, i, k]
                                np.add.at(wrote[key], (b, y[m], x[m], c[m]), 1)

                    # pass 1: g[q - d, d] and f1's halo; d w
                    halo = np.full((nhalo * qp, E), np.nan)
                    i = np.arange(nhalo * Q)
                    halo[(i // Q) * qp + i % Q] = units(f1, i // Q, i % Q)
                    dw = sums(halo, stage_g(True), d_f1=False)
                    if flow is None:
                        store(df2, "df2", dw)

                    # pass 2: g[p, d] and the warped halo (border, then owners); d f1
                    halo = np.full((nhalo * qp, E), np.nan)
                    count = np.zeros(nhalo * qp, np.int64)
                    if flow is None:
                        halo[(i // Q) * qp + i % Q] = units(f2, i // Q, i % Q)
                        count[(i // Q) * qp + i % Q] += 1
                    else:
                        hp, u = i // Q, i % Q
                        hy, hx = hp // hw, hp % hw
                        border = ~((hy >= md) & (hy < md + TH) & (hx >= md) & (hx < md + TW))
                        hp, u = hp[border], u[border]
                        halo[hp * qp + u] = warp_units(f2, b, taps, hp, cb + u * E, C, E, W)
                        count[hp * qp + u] += 1
                        part = np.full((npix, NS, 2), np.nan)
                        for i_ in range(R):
                            x = x0 + run * R + i_
                            hp = (row + md) * hw + run * R + i_ + md
                            on = (y < H) & (x < W)
                            gsum = np.zeros((threads, 2))
                            for tq in range(QS):
                                c = c0 + tq * E
                                m = on & (c < C)
                                w, terms = warp_units(f2, b, taps, hp, c, C, E, W, dw=dw[:, i_,
                                                      tq * E:(tq + 1) * E], acc=df2, mask=m)
                                halo[hp * qp + s * QS + tq] = np.where(m[:, None], w, 0.0)
                                count[hp * qp + s * QS + tq] += 1
                                gsum += np.where(m[:, None], terms, 0.0)
                            part[row * TW + run * R + i_, s] = gsum
                        assert not np.isnan(part).any()
                        blks.append(part.sum(axis=1))   # slots in order (float64)
                    assert (count.reshape(nhalo, qp)[:, :Q] == 1).all()
                    df1_pass = sums(halo, stage_g(False), d_f1=True)
                    store(df1, "df1", df1_pass)
                if flow is not None:   # the cluster's ranks in order; rank k stores its share
                    stored = np.zeros(npix, np.int64)
                    for rank in range(G):
                        for t in range(threads):
                            for qq in range(rank * threads + t, npix, G * threads):
                                stored[qq] += 1
                                qy, qx = by * TH + qq // TW, tx * TW + qq % TW
                                if qy >= H or qx >= W:
                                    continue
                                v = sum(blk[qq] for blk in blks)
                                hp = (qq // TW + md) * hw + qq % TW + md
                                if taps_of["valid"][hp]:
                                    dflow[b, 0, qy, qx] = (np.float32(v[0]) * taps_of["ex"][hp]
                                                           * np.float32(scale))
                                    dflow[b, 1, qy, qx] = (np.float32(v[1]) * taps_of["ey"][hp]
                                                           * np.float32(scale))
                                wrote["dflow"][b, qy, qx] += 1
                    assert (stored == 1).all()
    assert (wrote["df1"] == 1).all()
    assert (wrote["df2"] == 1).all() if flow is None else (wrote["dflow"] == 1).all()
    return df1, df2, dflow


def warp_units(f2, b, taps, hp, c, C, E, W, dw=None, acc=None, mask=None):
    """The blend of E channels from c at halo pixels hp (B1's rule, float64
    values, float32 weights); with d w (an owner) also d f2's scatter into
    `acc` and d flow's terms (gx, gy) over those channels."""
    n = len(hp)
    yi, xi, hx, hy = taps["yi"][hp], taps["xi"][hp], taps["hx"][hp], taps["hy"][hp]
    valid = taps["valid"][hp] & (c < C) & (True if mask is None else mask)
    wx, wy = taps["wx"][hp].astype(np.float64), taps["wy"][hp].astype(np.float64)
    ax, ay = taps["ax"][hp].astype(np.float64), taps["ay"][hp].astype(np.float64)
    vals = {}
    for key, (ty_, tx_) in {"00": (0, 0), "01": (0, 1), "10": (1, 0), "11": (1, 1)}.items():
        yy, xx = yi + ty_ * hy, xi + tx_ * hx
        v = np.zeros((n, E))
        for e in range(E):
            m = valid & (c + e < C)
            v[m, e] = f2[b, yy[m], xx[m], c[m] + e]
        vals[key] = (v, yy, xx)
    v00, v01, v10, v11 = (vals[k][0] for k in ("00", "01", "10", "11"))
    w = ((v00 * ax[:, None] + v01 * wx[:, None]) * ay[:, None]
         + (v10 * ax[:, None] + v11 * wx[:, None]) * wy[:, None]) * valid[:, None]
    if dw is None:
        return w
    top, bot = dw * ay[:, None], dw * wy[:, None]
    for key, part in (("00", top * ax[:, None]), ("01", top * wx[:, None]),
                      ("10", bot * ax[:, None]), ("11", bot * wx[:, None])):
        _, yy, xx = vals[key]
        for e in range(E):
            m = valid & (c + e < C)
            np.add.at(acc, (b, yy[m], xx[m], c[m] + e), part[m, e])
    z01, z10 = v01 * hx[:, None], v10 * hy[:, None]
    z11 = v11 * (hx * hy)[:, None]
    tx = (z01 - v00) * ay[:, None] + (z11 - z10) * wy[:, None]
    ty = (z10 - v00) * ax[:, None] + (z11 - z01) * wx[:, None]
    terms = np.stack([(dw * tx * valid[:, None]).sum(1), (dw * ty * valid[:, None]).sum(1)], 1)
    return w, terms


def _forced(shape, itemsize, flow, md):
    """The mappings replayed at a shape: a spread of the grid (the smallest
    tile, the largest of each run, one and the most groups)."""
    B, C, H, W = shape
    grid = lc.backward_mappings(B, C, H, W, md, itemsize, flow)
    picks = {min(grid, key=lambda q: (q.tile_h * q.tile_w, q.slots)),
             max(grid, key=lambda q: (q.groups, q.tile_h * q.tile_w)),
             min(grid, key=lambda q: (q.groups, -q.tile_h * q.tile_w))}
    picks |= {max((q for q in grid if q.run == r), key=lambda q: (q.tile_h * q.tile_w, q.slots))
              for r in lc.BWD_RUNS}
    return sorted(picks, key=lambda q: q.key)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


REPLAYS = [((2, 21, 7, 13), 2, 4), ((1, 10, 5, 9), 1, 4), ((1, 20, 9, 10), 4, 2),
           ((2, 12, 6, 8), 4, 4)]


@pytest.mark.parametrize("shape,md", [(s, md) for s, md, _ in REPLAYS])
def test_replayed_b2_backward_matches_plain(shape, md):
    """B2's backward (no flow, float32) replayed under its plan and a spread
    of the grid, with dout read at a pixel stride larger than (2md+1)^2 (as a
    channel slice is): d f0 and d f1 to the plain backward at 1e-10."""
    B, C, H, W = shape
    rng = np.random.RandomState(C + md)
    f0, f1 = rng.randn(B, H, W, C), rng.randn(B, H, W, C)
    S2 = (2 * md + 1) ** 2
    whole = rng.randn(B, H, W, S2 + 5)
    ref = tcorr.local_correlation_backward_plain(torch.from_numpy(f0), torch.from_numpy(f1),
                                                 torch.from_numpy(whole[..., :S2]), md)
    plans = _forced(shape, 4, False, md) + [lc.backward_plan(B, C, H, W, md, torch.float32, False)]
    for p in plans:
        d0, d1, _ = _replay(f0, f1, None, 0.0, whole, md, p, 4)
        assert _rel(d0, ref[0].numpy()) <= 1e-10, p
        assert _rel(d1, ref[1].numpy()) <= 1e-10, p


def _flow(rng, B, H, W, scale):
    """(B, 2, H, W) float32: fractional flows, 5-pixel steps that land on
    integer positions, zeros (the border's samples on the frame's edges) and
    flows that leave the frame."""
    kind = rng.randint(0, 4, (B, 1, H, W))
    frac = rng.uniform(-3, 3, (B, 2, H, W))
    ints = rng.randint(-1, 2, (B, 2, H, W)) * (5.0 / scale)
    far = rng.choice([-2.0 * W, 2.0 * W], (B, 2, H, W))
    flow = np.where(kind == 0, frac, np.where(kind == 1, ints, np.where(kind == 2, 0.0, far)))
    flow = flow.astype(np.float32)
    flow[0, :, [0, -1], :] = 0.0
    flow[0, :, :, [0, -1]] = 0.0
    return flow


@pytest.mark.parametrize("shape,md,itemsize", REPLAYS)
def test_replayed_warped_backward_matches_plain(shape, md, itemsize):
    """The warped correlation's backward replayed under its plan and a
    spread of the grid (clusters of 1 to 8 ranks), on flows that leave the
    frame and land exactly on its edges: d f1, d f2 and d flow to the plain
    backward at 1e-10 (d flow is float32 in both: the channel sum rounded
    once)."""
    B, C, H, W = shape
    scale = 1.25
    rng = np.random.RandomState(C + md + 1)
    f1, f2 = rng.randn(B, H, W, C), rng.randn(B, H, W, C)
    flow = _flow(rng, B, H, W, scale)
    S2 = (2 * md + 1) ** 2
    whole = rng.randn(B, H, W, S2 + 3)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)

    ref = tcorr.warped_correlation_nchw_backward_plain(nchw(f1), nchw(f2), torch.from_numpy(flow),
                                                       scale, nchw(whole[..., :S2]), md)
    want = [ref[0].permute(0, 2, 3, 1).numpy(), ref[1].permute(0, 2, 3, 1).numpy(),
            ref[2].numpy()]
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    plans = _forced(shape, itemsize, True, md)
    plans.append(lc.backward_plan(B, C, H, W, md, dtype, True))
    assert max(p.cluster for p in plans) > 1
    for p in plans:
        got = _replay(f1, f2, flow, scale, whole, md, p, itemsize)
        for name, g, w in zip(("d f1", "d f2", "d flow"), got, want):
            assert _rel(g, w) <= 1e-10, (name, p)
