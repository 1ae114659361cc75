"""The displacement volume's backward in the port against the JAX package.

`models/dicl.py::displacement_volume_backward_plain` is the plain version
of kernel B1's backward entry point (`dsfm_displacement_volume_backward`):
the explicit VJP of one DICL level's stack `shifted_pairs(x, warp_flow(y,
flow), md)` with respect to x and y (DICL detaches the flow). Here it is
held against `jax.vjp` of the JAX package's `shifted_pairs` of `warp_flow`
in float64, on inputs made with numpy from a seed: md 0 to 4, odd shapes,
flows that push samples off the frame or just past its border, all-zero
patches of y that open warp holes, and no flow (the coarsest level). The
warp's coordinates are float32 on both sides, as both packages compute
them. Also: the plain VJP against autograd of the plain forward (float32
and bfloat16), and the refusals of a flow that requires a gradient (the
kernel itself runs on the card: tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: float64 to 1e-12 of each gradient's largest element (the two
sum the same terms in other orders). Against autograd of the plain forward,
float32 to 1e-6 of the largest element (autograd sums the 49 displacements'
terms in another order); in bfloat16 against float32 autograd on the same
bf16 values, cast once, to one bf16 ulp at the largest element (2^-7 of it:
two float32 sums a few ulps apart may round to neighbouring bf16 values).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.models import dicl as jdicl
from deep_sfm_revisited_tpu_torch.models import dicl as tdicl
from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp

torch.set_num_threads(1)

SHAPES = [(2, 6, 9, 11), (1, 5, 13, 7)]     # (B, C, H, W)
# DICL's coarsest levels at 128x128: maps smaller than the search range
SMALL = [(1, 4, 2, 2), (2, 3, 4, 3)]


def _inputs(shape, seed, flow_kind, md):
    """x, y (B, H, W, C), a flow (B, H, W, 2) or None, and the stack's
    gradient (B, S2, H, W, 2C), float64 from a numpy seed. y has an all-zero
    patch (a warp hole); "off" sends a band of samples off the frame, a row
    just past the last one and a column just before the first."""
    B, C, H, W = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C)
    y = rng.randn(B, H, W, C)
    y[:, 2:6, 1:5] = 0.0
    S = 2 * md + 1
    g = rng.randn(B, S * S, H, W, 2 * C)
    if flow_kind == "none":
        return x, y, None, g
    flow = rng.uniform(-3, 3, (B, H, W, 2)).astype(np.float32)
    if H <= 5:      # a map smaller than the search range: samples toward its centre
        gy, gx = np.mgrid[0:H, 0:W]
        inward = np.stack([np.sign((W - 1) / 2 - gx), np.sign((H - 1) / 2 - gy)], -1)
        flow = (np.abs(flow) / 6 * inward).astype(np.float32)
    if H > 5 and W > 4:
        flow[:, 3:5, 2:4] = rng.uniform(-0.4, 0.4, (B, 2, 2, 2))
    if flow_kind == "off":
        flow[:, :, -2:, 0] = 3.0 * W
        flow[:, -1, :, 1] = 1.5
        flow[:, 0, :, 0] = -np.arange(W, dtype=np.float32) - 1e-3
    return x, y, flow, g


def _jax_vjp(x, y, flow, g, md):
    def stack(jx, jy):
        jy = jy if flow is None else jdicl.warp_flow(jy, jnp.asarray(flow))
        return jdicl.shifted_pairs(jx, jy, md)

    def grads(jx, jy, jg):      # jitted: eager VJPs of many slice shapes in one process
        out, vjp = jax.vjp(stack, jx, jy)   # have aborted inside jax's slice transpose
        assert out.dtype == jnp.float64
        return vjp(jg)

    return [np.asarray(v) for v in jax.jit(grads)(
        jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64), jnp.asarray(g, jnp.float64))]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_dout(g):
    """(B, S2, H, W, 2C) -> the port's (B, S2, 2C, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(g.transpose(0, 1, 4, 2, 3)))


CASES = [(shape, kind, md) for shape in SHAPES for kind in ("flow", "off", "none")
         for md in (0, 1, 2, 3, 4)] + [(shape, kind, 3) for shape in SMALL
                                       for kind in ("flow", "none")]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_backward_matches_jax_vjp(case):
    shape, kind, md = CASES[case]
    x, y, flow, g = _inputs(shape, case, kind, md)
    jdx, jdy = _jax_vjp(x, y, flow, g, md)
    tflow = None if flow is None else _nchw(flow)
    dx, dy = tdicl.displacement_volume_backward_plain(_port_dout(g), _nchw(x), _nchw(y), tflow,
                                                      md)
    assert dx.dtype == dy.dtype == torch.float64
    for got, want, name in ((dx, jdx, "dx"), (dy, jdy, "dy")):
        want = want.transpose(0, 3, 1, 2)
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * scale, err_msg=name)
    # the hole: y's all-zero patch gets no gradient where no flow moves a
    # sample into it (no flow: exactly zero)
    if kind == "none" and shape in SHAPES:
        assert not dy[:, :, 2:6, 1:5].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["off", "none"])
def test_plain_backward_matches_autograd(dtype, kind):
    md = 3
    x, y, flow, g = _inputs(SHAPES[0], 7, kind, md)
    tx, ty, dout = _nchw(x).to(dtype), _nchw(y).to(dtype), _port_dout(g).to(dtype)
    tflow = None if flow is None else _nchw(flow)
    # autograd in float32 on the same (bf16-rounded) values, then cast
    fx, fy = tx.float().requires_grad_(), ty.float().requires_grad_()
    out = tdicl.displacement_volume(fx, fy, tflow, md)
    want = [w.to(dtype) for w in torch.autograd.grad(out, (fx, fy), dout.float())]
    got = tdicl.displacement_volume_backward_plain(dout, tx, ty, tflow, md)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    for a, b, name in zip(got, want, ("dx", "dy")):
        assert a.dtype == dtype, name
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale, name


def test_flow_that_requires_a_gradient_is_refused():
    """Both packages detach the flow a level warps with: the dispatcher, the
    autograd function and the kernel's wrappers refuse a flow that requires
    a gradient, before any device is touched; under no_grad it passes."""
    x, y, flow, _ = _inputs(SHAPES[0], 3, "flow", 2)
    tx, ty, tflow = _nchw(x).float(), _nchw(y).float(), _nchw(flow).requires_grad_()
    with pytest.raises(NotImplementedError, match="flow gradient"):
        tdicl.displacement_volume(tx, ty, tflow, 2)
    with pytest.raises(NotImplementedError, match="flow gradient"):
        tdicl.DisplacementVolumeFn.apply(tx, ty, tflow, 2)
    with pytest.raises(NotImplementedError, match="flow gradient"):
        sweep_warp.displacement_volume_backward_cuda(
            torch.zeros(2, 25, 12, 9, 11), ty, tflow, 2)
    with torch.no_grad():
        assert tdicl.displacement_volume(tx, ty, tflow, 2).shape == (2, 25, 12, 9, 11)


def test_backward_wrapper_refuses_what_the_kernel_does_not_take():
    """The backward's wrapper checks dout against y's shape and dtype, and
    refuses CPU tensors, before anything is built."""
    y = torch.zeros(1, 8, 6, 10)
    flow = torch.zeros(1, 2, 6, 10)
    dout = torch.zeros(1, 49, 16, 6, 10)
    before = sweep_warp.DISPLACEMENT_BACKWARD.launches
    for args, error in (((dout, y, flow, 3), ValueError),            # CPU tensors
                        ((dout[:, :25], y, flow, 3), ValueError),     # md 3 needs 49
                        ((dout.bfloat16(), y, flow, 3), ValueError),  # two dtypes
                        ((dout, y, flow, 5), ValueError),             # md beyond 4
                        ((dout.transpose(3, 4), y, flow, 3), ValueError),
                        ((dout, y.double(), flow, 3), TypeError)):
        with pytest.raises(error):
            sweep_warp.displacement_volume_backward_cuda(*args)
    assert sweep_warp.DISPLACEMENT_BACKWARD.launches == before


# the flow-training step's five levels (b = 4, 256x768; level 2 with one
# batch item, whose blocks repeat per item), odd shapes, a map smaller than a
# tile, and one whose width is not a multiple of the run
PLAN_SHAPES = [(1, 32, 64, 192), (4, 32, 32, 96), (4, 32, 16, 48), (4, 32, 8, 24),
               (4, 32, 4, 12), (2, 16, 13, 27), (1, 5, 9, 51), (2, 3, 2, 2), (1, 64, 7, 200)]


def _kernel_constant(name):
    src = (Path(sweep_warp.__file__).resolve().parents[2] / "csrc" / "sweep_warp.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_backward_plan_covers_every_element(shape, itemsize):
    """The backward kernel's work mapping (`sweep_warp.displacement_backward_plan`),
    replayed with the kernel's index arithmetic for md 0..4: every (b, c, p)
    of dx and dy is written by exactly one lane, ragged tiles included; every
    flag a lane reads (q = p + d for its pixels, and its own pixels' holes)
    lies in its block's halo rows and flag words, and is the flag of that
    very q, zero off the frame; and the y half's two runs (its own and the
    neighbour the sign of du picks) give dout at q - d, zero exactly where
    that column leaves the frame."""
    B, C, h, w = shape
    assert (sweep_warp.DISP_BWD_THREADS, sweep_warp.DISP_BWD_ROWS, sweep_warp.DISP_BWD_CHUNKS,
            sweep_warp.DISP_BWD_WORDS) == tuple(_kernel_constant(n) for n in (
                "kDispBwdThreads", "kDispBwdRows", "kDispBwdChunks", "kDispBwdWords"))
    rows, chunks, words = (sweep_warp.DISP_BWD_ROWS, sweep_warp.DISP_BWD_CHUNKS,
                           sweep_warp.DISP_BWD_WORDS)
    for md in range(5):
        p = sweep_warp.displacement_backward_plan(B, C, h, w, itemsize)
        run, S = p.run, 2 * md + 1
        assert p.vector == (w % run == 0) and p.tile_w == chunks * run
        assert not sweep_warp.displacement_backward_plan(B, C, h, w, itemsize, False).vector
        halo_rows, halo_w = rows + 2 * md, p.tile_w + 2 * md
        assert halo_w + run <= 32 * (words - 1)            # the kernel's static_assert

        # every lane of every block, as the kernel decodes them
        blk, tid = np.meshgrid(np.arange(p.blocks), np.arange(sweep_warp.DISP_BWD_THREADS),
                               indexing="ij")
        blk, tid = blk.ravel(), tid.ravel()
        tx, rest = blk % p.tiles_x, blk // p.tiles_x
        ty, rest = rest % p.tiles_y, rest // p.tiles_y
        cg, b = rest % p.cgroups, rest // p.cgroups
        warp, lane = tid // 32, tid % 32
        c = cg * (sweep_warp.DISP_BWD_THREADS // 32) + warp
        rr, kk = lane // chunks, lane % chunks
        x0, y0 = tx * p.tile_w, ty * rows
        r, col0 = y0 + rr, x0 + kk * run
        act = (c < C) & (r < h) & (col0 < w)
        b, c, rr, kk, r, col0, x0, y0 = (a[act] for a in (b, c, rr, kk, r, col0, x0, y0))
        assert (b < B).all()

        written = np.zeros((B, C, h, w), np.int64)
        for j in range(run):
            m = col0 + j < w
            np.add.at(written, (b[m], c[m], r[m], col0[m] + j), 1)
        assert (written == 1).all()

        start = kk * run                                   # the window's first flag bit
        assert ((start >> 5) + 1 < words).all()
        for dvi in range(S):
            hr = rr + dvi                                  # the halo row of q = p + d
            assert ((hr >= 0) & (hr < halo_rows)).all()
            qy = y0 - md + hr
            assert (qy == r + dvi - md).all()
            for dui in range(S):
                du = dui - md
                for j in range(run):
                    own = col0 + j < w
                    bit = j + dui
                    assert bit < 32
                    hc = start + bit                       # the halo column of q
                    assert ((hc >= 0) & (hc < halo_w)).all()
                    qx = x0 - md + hc
                    assert (qx == col0 + j + du).all()
                    # the flag the prologue wrote there: in the frame (and hole)
                    in_frame = (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w)
                    assert (in_frame == ((r + dvi - md >= 0) & (r + dvi - md < h)
                                         & (col0 + j + du >= 0) & (col0 + j + du < w))).all()
                    # the y half: dout[s, C + c, r - dv, col0 + j - du]
                    src = col0 + j - du
                    if p.vector:
                        k = j - du
                        # the staged y row holds runs -1..chunks of the tile
                        assert ((kk - (du > 0) + (du < 0) >= -1)
                                & (kk - (du > 0) + (du < 0) <= chunks)).all()
                        ncol = col0 - run if du > 0 else col0 + run
                        if k < 0:
                            got, zero = ncol + run + k, ncol < 0
                        elif k >= run:
                            got, zero = ncol + k - run, ncol >= w
                        else:
                            got, zero = col0 + k, np.zeros_like(own)
                        assert (got == src).all()
                        assert (zero[own] == ((src < 0) | (src >= w))[own]).all()
        # the own pixels' holes: halo row rr + md, bits from start + md
        assert ((start + md + run - 1) < halo_w).all()
