"""Tests that need an NVIDIA GPU: the port's kernels (B1's gather,
displacement volume and its backward, plane sweep, sweep backward and sweep
pose gradient, B2, and PWC-DC's warped correlation in its NCHW layout and
dtype, and the two correlations' backward kernels) against their plain
versions,
and the pose engine on the card against itself on the CPU.

They skip where no card is present. This file imports no jax, so it also
runs on a machine without JAX, from the repository root:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from deep_sfm_revisited_tpu_torch.ops import camera as tcam
from deep_sfm_revisited_tpu_torch.ops import correlation as tcorr
from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr, sweep_warp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b1_kernel_matches_plain_on_card(dtype):
    """B1 against its plain version on the card: f32 and bf16 bit-exact
    (both round op by op without FMA contraction)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    for (b, h, w, c, q) in ((1, 96, 320, 32, (7, 96, 320)),
                            (2, 12, 20, 32, (5, 7, 9)),
                            (1, 9, 11, 3, (13,))):   # scalar (non-vector) path
        img = torch.randn(b, h, w, c, device="cuda", generator=g).to(td)
        coords = torch.rand(b, *q, 2, device="cuda", generator=g) * 1.4 - 0.2
        coords = coords * torch.tensor([w - 1.0, h - 1.0], device="cuda")
        coords[:, 0] = torch.tensor([2.0 * w, 2.0 * h], device="cuda")
        before = sweep_warp.KERNEL.launches
        got = sweep_warp.bilinear_sample_cuda(img, coords)
        torch.cuda.synchronize()
        assert sweep_warp.KERNEL.launches == before + 1
        ref = tcam.bilinear_sample_plain(img, coords)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


# (B, D, H, W, C) and pose: PSNet's shape (KITTI's 384x1280 at 1/4, 128
# planes), batch 2 with odd H and W and C = 8 (one thread per pixel in bf16),
# C = 24 (a block size that is no multiple of the threads per pixel), a pose
# that puts the near planes behind the camera, and one that pushes most
# samples out of the frame
SWEEP_CASES = [((1, 128, 96, 320, 32), "forward"), ((2, 7, 13, 27, 8), "forward"),
               ((1, 5, 9, 50, 24), "forward"), ((1, 16, 24, 40, 32), "behind"),
               ((1, 16, 24, 40, 32), "outward")]
SWEEP_T = {"forward": (0.2, 0.05, 0.9), "behind": (0.1, -0.1, -2.5), "outward": (4.0, 0.5, 0.3)}


def _sweep_inputs(shape, pose_kind, dtype, seed=0):
    """ref, tgt, depths, M, Kt on the card: KITTI's K at 1/4 resolution scaled
    to W, a small rotation, PSNet's plane depths (min_depth nlabel / label)."""
    from deep_sfm_revisited_tpu_torch.ops import rotations

    B, D, H, W, C = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    ref = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    tgt = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    f = 718.856 / 4 * W / 320
    K = torch.tensor([[f, 0, W / 2 - 0.4], [0, f, H / 2 + 0.3], [0, 0, 1]], device="cuda")
    R = rotations.angle_to_matrix(torch.tensor([0.01, -0.02, 0.005], device="cuda"))
    t = torch.tensor(SWEEP_T[pose_kind], device="cuda")[:, None]
    pose = torch.cat([R, t], dim=1).expand(B, 3, 4)
    M, Kt = tcam.sweep_matrices(pose, K.expand(B, 3, 3), torch.linalg.inv(K).expand(B, 3, 3))
    depths = D / torch.arange(1, D + 1, dtype=torch.float32, device="cuda")
    return ref, tgt, depths, M, Kt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,pose_kind", SWEEP_CASES)
def test_sweep_kernel_matches_plain_on_card(shape, pose_kind, dtype):
    """The sweep kernel against its plain version on the card, bit for bit
    in f32 and bf16 (both round op by op in the same order, no FMA
    contraction); exact zeros where the sample is invalid, the ref half on
    every plane, and channels-last-3d strides for the NCDHW view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, D, H, W, C = shape
    ref, tgt, depths, M, Kt = _sweep_inputs(shape, pose_kind, getattr(torch, dtype))
    before = sweep_warp.VOLUME.launches
    got = sweep_warp.plane_sweep_volume_cuda(ref, tgt, depths, M, Kt)
    torch.cuda.synchronize()
    assert sweep_warp.VOLUME.launches == before + 1
    assert got.shape == (B, D, H, W, 2 * C) and got.dtype == ref.dtype
    torch.testing.assert_close(got, tcam.plane_sweep_volume_plain(ref, tgt, depths, M, Kt),
                               rtol=0, atol=0)
    assert torch.equal(got[..., :C], ref[:, None].expand(B, D, H, W, C))
    x, y = tcam.sweep_pixel_coords(depths, M, Kt, H, W)
    invalid = (x < 0) | (x > W - 1) | (y < 0) | (y > H - 1)
    assert bool((got[..., C:][invalid] == 0).all())
    assert bool((got[..., C:][~invalid] != 0).any())
    if pose_kind == "behind":
        assert bool(invalid[:, -1].all()) and not bool(invalid[:, 0].all())
    if pose_kind == "outward":
        assert float(invalid.float().mean()) > 0.5
    assert got.permute(0, 4, 1, 2, 3).is_contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_kernel_is_deterministic(dtype):
    """Two launches on PSNet's shape give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _sweep_inputs((1, 128, 96, 320, 32), "forward", getattr(torch, dtype), seed=1)
    first = sweep_warp.plane_sweep_volume_cuda(*args)
    second = sweep_warp.plane_sweep_volume_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_sweep_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ref, tgt, depths, M, Kt = _sweep_inputs((1, 4, 8, 8, 8), "forward", torch.float32)
    odd = torch.zeros(1, 8, 8, 3, device="cuda")       # 12-byte rows
    for args in ((ref, tgt.bfloat16(), depths, M, Kt), (odd, odd, depths, M, Kt),
                 (ref, tgt.transpose(1, 2), depths, M, Kt), (ref, tgt, depths.cpu(), M, Kt),
                 (ref, tgt, depths, M.double(), Kt), (ref, tgt, depths, M[:, :2], Kt),
                 (ref, tgt[:, :4], depths, M, Kt)):
        with pytest.raises((ValueError, TypeError)):
            sweep_warp.plane_sweep_volume_cuda(*args)


# the sweep backward: the training shape (b = 4, 256x768 at 1/4, 128 planes)
# and the odd shapes and poses of the forward's cases
BWD_CASES = [((4, 128, 64, 192, 32), "forward")] + SWEEP_CASES[1:]


def _bwd_tolerance(got, want):
    """float32 atomics in another order: 1e-5 max|plain| + 1e-6, plus one
    bf16 ulp of the element when both sums were cast to bf16."""
    tol = 1e-5 * float(want.float().abs().max()) + 1e-6
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
        tol = tol + torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)
    return tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,pose_kind", BWD_CASES)
def test_sweep_backward_matches_plain_on_card(shape, pose_kind, dtype):
    """The sweep backward kernel against its plain VJP on the card, within
    `_bwd_tolerance`; dtgt exactly zero wherever no valid sample lands; dref
    bit-identical across two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, D, H, W, C = shape
    td = getattr(torch, dtype)
    _, _, depths, M, Kt = _sweep_inputs(shape, pose_kind, td)
    g = torch.Generator(device="cuda").manual_seed(2)
    dvol = torch.randn(B, D, H, W, 2 * C, device="cuda", generator=g).to(td)
    before = sweep_warp.VOLUME_BACKWARD.launches
    dref, dtgt = sweep_warp.plane_sweep_volume_backward_cuda(dvol, depths, M, Kt)
    dref2, _ = sweep_warp.plane_sweep_volume_backward_cuda(dvol, depths, M, Kt)
    torch.cuda.synchronize()
    assert sweep_warp.VOLUME_BACKWARD.launches == before + 2
    assert dref.shape == dtgt.shape == (B, H, W, C) and dref.dtype == dtgt.dtype == td
    assert torch.equal(dref, dref2)
    pref, ptgt = tcam.plane_sweep_volume_backward_plain(dvol, depths, M, Kt)
    for got, want in ((dref, pref), (dtgt, ptgt)):
        assert bool(((got.float() - want.float()).abs() <= _bwd_tolerance(got, want)).all())
    _, landed = tcam.plane_sweep_volume_backward_plain(torch.ones_like(dvol, dtype=torch.float32),
                                                      depths, M, Kt)
    empty = (landed == 0).all(dim=-1)
    assert bool((dtgt[empty] == 0).all())
    if pose_kind != "forward":
        assert bool(empty.any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_backward_through_autograd_on_card(dtype):
    """Features that need a gradient go through PlaneSweepVolumeFn: one
    forward and one backward launch, gradients equal to the plain VJP's
    within `_bwd_tolerance`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    ref, tgt, depths, _, _ = _sweep_inputs((2, 16, 24, 40, 32), "forward", td, seed=3)
    f = 718.856 / 4 * 40 / 320
    K = torch.tensor([[[f, 0, 20.0], [0, f, 12.0], [0, 0, 1]]], device="cuda").expand(2, 3, 3)
    pose = torch.tensor([[[1.0, 0, 0.01, 0.2], [0, 1, 0, 0.05], [-0.01, 0, 1, 0.9]]],
                        device="cuda").expand(2, 3, 4)
    ref.requires_grad_()
    tgt.requires_grad_()
    n = (sweep_warp.VOLUME.launches, sweep_warp.VOLUME_BACKWARD.launches)
    vol = tcam.plane_sweep_volume(ref, tgt, depths, pose, K, torch.linalg.inv(K))
    dvol = torch.randn(vol.shape, device="cuda").to(td)
    gref, gtgt = torch.autograd.grad(vol, (ref, tgt), dvol)
    torch.cuda.synchronize()
    assert (sweep_warp.VOLUME.launches, sweep_warp.VOLUME_BACKWARD.launches) == (n[0] + 1,
                                                                                 n[1] + 1)
    M, Kt = tcam.sweep_matrices(pose, K, torch.linalg.inv(K))
    pref, ptgt = tcam.plane_sweep_volume_backward_plain(dvol, depths, M, Kt)
    for got, want in ((gref, pref), (gtgt, ptgt)):
        assert bool(((got.float() - want.float()).abs() <= _bwd_tolerance(got, want)).all())


@pytest.mark.cuda
def test_sweep_backward_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, depths, M, Kt = _sweep_inputs((1, 4, 8, 8, 8), "forward", torch.float32)
    dvol = torch.zeros(1, 4, 8, 8, 16, device="cuda")
    for args in ((dvol.double(), depths, M, Kt), (dvol[..., :6], depths, M, Kt),
                 (dvol.transpose(2, 3), depths, M, Kt), (dvol, depths[:3], M, Kt),
                 (dvol, depths.cpu(), M, Kt), (dvol, depths, M.double(), Kt),
                 (dvol, depths, M, Kt[:, :2])):
        with pytest.raises((ValueError, TypeError)):
            sweep_warp.plane_sweep_volume_backward_cuda(*args)


# the sweep's pose gradient: the training shape, the odd shapes whose channel
# chunks a pixel are a power of two, the poses of the forward's cases, and
# plane counts that the kernel's groups of 16 planes do not divide (37 = 2 x
# 16 + 5, and 7 in the odd shape above)
POSE_GRAD_CASES = [case for case in BWD_CASES if case[0][-1] != 24] + [
    ((2, 37, 20, 44, 32), "forward"), ((1, 21, 24, 40, 16), "behind")]


def _pose_grad_close(got, want):
    """A fixed-order float64 sum of float32 per-sample terms against the
    plain version's other order: 1e-5 of the largest magnitude (measured at
    the training shape: 1.6e-7)."""
    return bool(((got - want).abs() <= 1e-5 * float(want.abs().max()) + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,pose_kind", POSE_GRAD_CASES)
def test_sweep_pose_grad_matches_plain_on_card(shape, pose_kind, dtype):
    """The pose-gradient kernel against its plain version on the card; dM
    and dK t bit-identical across two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, D, H, W, C = shape
    td = getattr(torch, dtype)
    _, tgt, depths, M, Kt = _sweep_inputs(shape, pose_kind, td)
    g = torch.Generator(device="cuda").manual_seed(4)
    dvol = torch.randn(B, D, H, W, 2 * C, device="cuda", generator=g).to(td)
    before = sweep_warp.VOLUME_POSE_GRAD.launches
    dM, dKt = sweep_warp.plane_sweep_volume_pose_grad_cuda(dvol, tgt, depths, M, Kt)
    dM2, dKt2 = sweep_warp.plane_sweep_volume_pose_grad_cuda(dvol, tgt, depths, M, Kt)
    torch.cuda.synchronize()
    assert sweep_warp.VOLUME_POSE_GRAD.launches == before + 2
    assert dM.shape == (B, 3, 3) and dKt.shape == (B, 3)
    assert dM.dtype == dKt.dtype == torch.float32
    assert torch.equal(dM, dM2) and torch.equal(dKt, dKt2)
    pM, pKt = tcam.plane_sweep_volume_pose_grad_plain(dvol, tgt, depths, M, Kt)
    assert float(pM.abs().max()) > 0
    assert _pose_grad_close(dM, pM) and _pose_grad_close(dKt, pKt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_pose_grad_without_a_valid_sample_is_zero(dtype):
    """Every plane behind the camera: exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    _, tgt, depths, M, Kt = _sweep_inputs((2, 16, 24, 40, 32), "behind", td)
    Kt = Kt.clone()
    Kt[:, 2] = -1e4
    dvol = torch.ones(2, 16, 24, 40, 64, device="cuda", dtype=td)
    dM, dKt = sweep_warp.plane_sweep_volume_pose_grad_cuda(dvol, tgt, depths, M, Kt)
    torch.cuda.synchronize()
    assert bool((dM == 0).all()) and bool((dKt == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_pose_grad_through_autograd_on_card(dtype):
    """A pose that needs a gradient: one launch of the pose-gradient kernel
    per backward, the pose's gradient equal to the plain version's chained
    through `sweep_matrices`; a pose that needs none launches it no time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    ref, tgt, depths, _, _ = _sweep_inputs((2, 16, 24, 40, 32), "forward", td, seed=5)
    f = 718.856 / 4 * 40 / 320
    K = torch.tensor([[[f, 0, 20.0], [0, f, 12.0], [0, 0, 1]]], device="cuda").expand(2, 3, 3)
    K_inv = torch.linalg.inv(K)
    pose = torch.tensor([[[1.0, 0, 0.01, 0.2], [0, 1, 0, 0.05], [-0.01, 0, 1, 0.9]]],
                        device="cuda").repeat(2, 1, 1).requires_grad_()
    tgt.requires_grad_()
    n = sweep_warp.VOLUME_POSE_GRAD.launches
    vol = tcam.plane_sweep_volume(ref, tgt, depths, pose, K, K_inv)
    dvol = torch.randn(vol.shape, device="cuda").to(td)
    gpose, = torch.autograd.grad(vol, (pose,), dvol)
    torch.cuda.synchronize()
    assert sweep_warp.VOLUME_POSE_GRAD.launches == n + 1
    M, Kt = tcam.sweep_matrices(pose.detach(), K, K_inv)
    pM, pKt = tcam.plane_sweep_volume_pose_grad_plain(dvol, tgt.detach(), depths, M, Kt)
    want, = torch.autograd.grad(tcam.sweep_matrices(pose, K, K_inv), (pose,), (pM, pKt))
    assert _pose_grad_close(gpose, want)
    vol = tcam.plane_sweep_volume(ref, tgt, depths, pose.detach(), K, K_inv)
    torch.autograd.grad(vol, (tgt,), dvol)
    torch.cuda.synchronize()
    assert sweep_warp.VOLUME_POSE_GRAD.launches == n + 1


@pytest.mark.cuda
def test_sweep_pose_grad_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tgt, depths, M, Kt = _sweep_inputs((1, 4, 8, 8, 8), "forward", torch.float32)
    dvol = torch.zeros(1, 4, 8, 8, 16, device="cuda")
    odd = torch.zeros(1, 8, 8, 24, device="cuda")      # 6 chunks a pixel: no power of two
    for args in ((dvol.bfloat16(), tgt, depths, M, Kt), (dvol, tgt.cpu(), depths, M, Kt),
                 (dvol, tgt.transpose(1, 2), depths, M, Kt), (dvol, tgt, depths[:3], M, Kt),
                 (dvol, tgt, depths, M.double(), Kt), (dvol, tgt, depths, M, Kt[:, :2]),
                 (torch.zeros(1, 4, 8, 8, 48, device="cuda"), odd, depths, M, Kt)):
        with pytest.raises((ValueError, TypeError)):
            sweep_warp.plane_sweep_volume_pose_grad_cuda(*args)


# the sweep backward's two paths, forced: the default mapping on a forward
# pose (shared boxes), a one-pixel accumulator (every group direct), and a
# pose that puts the near planes behind the camera, in groups of 4 planes so
# that the far groups lie in front (direct groups beside shared ones);
# C = 8, 32 and 64
BWD_PATHS = [("shared", "forward", None, None), ("too large", "forward", 1, None),
             ("behind", "behind", None, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [8, 32, 64])
@pytest.mark.parametrize("path,pose_kind,cap,planes", BWD_PATHS)
def test_sweep_backward_paths_on_card(path, pose_kind, cap, planes, C, dtype):
    """Each path of the sweep backward against the plain VJP within
    `_bwd_tolerance`, with the kernel's counts of shared and direct groups,
    samples that left their box and 16-byte reductions equal to the plain
    box rule's (`sweep_backward_counts`); dref bit-identical to the
    default launch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    shape = (2, 24, 20, 44, C)
    B, D, H, W, _ = shape
    _, _, depths, M, Kt = _sweep_inputs(shape, pose_kind, td, seed=4)
    g = torch.Generator(device="cuda").manual_seed(5)
    dvol = torch.randn(B, D, H, W, 2 * C, device="cuda", generator=g).to(td)
    tile_h, tile_w, default_planes, smem = sweep_warp.backward_plan(C, dvol.element_size())
    planes = planes or default_planes
    if cap is not None:
        smem = cap * 4 * C
    dref, acc, counts = sweep_warp.plane_sweep_volume_backward_probe(
        dvol, depths, M, Kt, (tile_h, tile_w, planes, smem))
    want = tcam.sweep_backward_counts(depths, M, Kt, H, W, C, tile_h, tile_w, planes,
                                      smem // (4 * C))
    assert counts == want
    if path == "shared":
        assert counts["direct_groups"] == 0 and counts["shared_groups"] > 0
    elif path == "too large":     # only empty or one-pixel boxes stay shared
        assert counts["direct_groups"] > 0
        assert counts["global_reductions"] > counts["direct_groups"] * C
    else:
        assert counts["direct_groups"] > 0 and counts["shared_groups"] > 0
    pref, ptgt = tcam.plane_sweep_volume_backward_plain(dvol, depths, M, Kt)
    for got, want_ in ((dref, pref), (acc.to(td), ptgt)):
        assert bool(((got.float() - want_.float()).abs() <= _bwd_tolerance(got, want_)).all())
    dref2, _ = sweep_warp.plane_sweep_volume_backward_cuda(dvol, depths, M, Kt)
    assert torch.equal(dref, dref2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_replays_in_a_cuda_graph(dtype):
    """The gather captured in a CUDA graph (after a warm-up on a side stream)
    counts one launch at capture and none at replay, and a replay on new
    inputs written in place equals an eager call bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(8)
    img = torch.randn(1, 48, 160, 32, device="cuda", generator=g).to(td)
    coords = torch.rand(1, 48, 160, 2, device="cuda", generator=g) * 170 - 5
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sweep_warp.bilinear_sample_cuda(img, coords)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = sweep_warp.KERNEL.launches
    with torch.cuda.graph(graph):
        out = sweep_warp.bilinear_sample_cuda(img, coords)
    assert sweep_warp.KERNEL.launches == n + 1
    img.copy_(torch.randn(img.shape, device="cuda", generator=g).to(td))
    coords.copy_(torch.rand(coords.shape, device="cuda", generator=g) * 170 - 5)
    graph.replay()
    torch.cuda.synchronize()
    assert sweep_warp.KERNEL.launches == n + 1
    assert torch.equal(out, sweep_warp.bilinear_sample_cuda(img, coords))
    assert torch.equal(out, tcam.bilinear_sample_plain(img, coords))


# DICL's displacement volume: slice 1's five level shapes (b = 1, 384x1280:
# levels 6..2, C = 32, md = 3, no flow at level 6), the training step's
# five (b = 4, 256x768), a batch of two with odd H and W and md = 2, C = 5
# on odd W (one element a store), w = 36 (8-byte stores in bf16), and w = 6
# at md 4 (4-byte stores in bf16, a tile narrower than the halo)
DISP_CASES = [((1, 32, 6, 20), 3, False), ((1, 32, 12, 40), 3, True),
              ((1, 32, 24, 80), 3, True), ((1, 32, 48, 160), 3, True),
              ((1, 32, 96, 320), 3, True), ((4, 32, 4, 12), 3, False),
              ((4, 32, 8, 24), 3, True), ((4, 32, 16, 48), 3, True),
              ((4, 32, 32, 96), 3, True), ((4, 32, 64, 192), 3, True),
              ((2, 16, 13, 27), 2, True), ((1, 5, 9, 51), 3, True),
              ((2, 32, 10, 36), 3, True), ((1, 8, 5, 6), 4, True)]


def _disp_inputs(shape, with_flow, dtype, seed=0):
    """x, y (B, C, h, w) with an all-zero patch of y (warp holes) and a flow
    (B, 2, h, w) of a few pixels that sends a band of samples off the frame,
    or None."""
    B, C, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, device="cuda", generator=g).to(dtype)
    y = torch.randn(shape, device="cuda", generator=g)
    y[:, :, h // 4:h // 2, w // 4:w // 2] = 0
    y = y.to(dtype)
    if not with_flow:
        return x, y, None
    flow = (torch.rand(B, 2, h, w, device="cuda", generator=g) - 0.5) * 6
    flow[:, 0, :, -2:] = 2.0 * w
    return x, y, flow


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,md,with_flow", DISP_CASES)
def test_displacement_volume_matches_plain_on_card(shape, md, with_flow, dtype):
    """The displacement-volume kernel against its plain version (the
    composition it replaced, with the gather's plain version), bit for bit
    in f32 and bf16: the samples use B1's taps and blend, rounded op by op,
    and the masks are 0 or 1. Two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import dicl as tdicl

    x, y, flow = _disp_inputs(shape, with_flow, getattr(torch, dtype))
    before = sweep_warp.DISPLACEMENT.launches
    got = sweep_warp.displacement_volume_cuda(x, y, flow, md)
    again = sweep_warp.displacement_volume_cuda(x, y, flow, md)
    torch.cuda.synchronize()
    assert sweep_warp.DISPLACEMENT.launches == before + 2
    B, C, h, w = shape
    assert got.shape == (B, (2 * md + 1) ** 2, 2 * C, h, w) and got.dtype == x.dtype
    assert torch.equal(got, again)
    want = tdicl.displacement_volume_plain(x, y, flow, md)
    assert torch.equal(got, want)
    assert torch.equal(tdicl.displacement_volume(x, y, flow, md), want)
    holes = (want[:, :, C:] == 0).all(2) & ~_outside(h, w, md).permute(2, 0, 1)
    assert bool(holes.any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_displacement_volume_replays_in_a_cuda_graph(dtype):
    """The volume kernel captured in a CUDA graph (after a warm-up on a side
    stream) counts one launch at capture and none at replay, and a replay on
    new inputs written in place equals an eager call bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    x, y, flow = _disp_inputs((1, 32, 48, 160), True, td, seed=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sweep_warp.displacement_volume_cuda(x, y, flow, 3)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = sweep_warp.DISPLACEMENT.launches
    with torch.cuda.graph(graph):
        out = sweep_warp.displacement_volume_cuda(x, y, flow, 3)
    assert sweep_warp.DISPLACEMENT.launches == n + 1
    for t, new in zip((x, y, flow), _disp_inputs((1, 32, 48, 160), True, td, seed=4)):
        t.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    assert sweep_warp.DISPLACEMENT.launches == n + 1
    assert torch.equal(out, sweep_warp.displacement_volume_cuda(x, y, flow, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,md", [((4, 32, 16, 48), 3), ((2, 16, 13, 27), 2),
                                      ((1, 32, 12, 40), 4)])
def test_displacement_volume_plans_agree_on_card(shape, md, dtype):
    """Every work mapping of a grid (bands of 1, 2 and 3 rows, 1 to 3 tiles
    a row, 16-byte or narrower stores from an x that starts 8 or 2 bytes
    past a 16-byte boundary, a grid of one block, the sampling in its own
    launch or fused into the store kernel) gives the plain version's stack
    bit for bit, and so does the default mapping of a y that starts there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import dicl as tdicl

    B, C, h, w = shape
    x, y, flow = _disp_inputs(shape, True, getattr(torch, dtype), seed=5)
    want = tdicl.displacement_volume_plain(x, y, flow, md)
    for offset in (0, 8, 2):
        n = offset // x.element_size()
        xo = torch.empty(x.numel() + n + 8, dtype=x.dtype, device="cuda")[n:n + x.numel()]
        xo = xo.view(shape).copy_(x) if n else x
        yo = torch.empty(y.numel() + n + 8, dtype=y.dtype, device="cuda")[n:n + y.numel()]
        yo = yo.view(shape).copy_(y) if n else y
        # the default mapping follows the alignment of x and of y
        assert torch.equal(sweep_warp.displacement_volume_cuda(x, yo, flow, md), want)
        for bh in (1, 2, 3):
            for k in (1, 2, 3):
                p = sweep_warp.displacement_plan(
                    B, C, h, w, md, x.element_size(), aligned=sweep_warp.address_alignment(xo),
                    band_h=bh, tiles_x=k)
                for grid in (p.grid, 1):
                    for fused in (False, True):
                        q = dataclasses.replace(p, grid=grid, fused=fused)
                        got = sweep_warp.displacement_volume_cuda(xo, y, flow, md, q)
                        assert torch.equal(got, want), (offset, q)


# the flow-training step's five levels (b = 4, 256x768) and odd ones, md 0..4:
# w not a multiple of the 8-pixel bf16 run (27, 51, 20 -- a multiple of the
# 4-pixel float32 run -- and 33), h smaller than a tile of 4 rows (3), a
# multiple of 8 with odd h
DISP_BWD_CASES = [((4, 32, 64, 192), 3, True), ((4, 32, 4, 12), 3, False),
                  ((2, 16, 13, 27), 0, True), ((2, 16, 13, 27), 4, True),
                  ((1, 5, 9, 51), 2, False), ((2, 8, 3, 40), 1, True),
                  ((1, 16, 9, 64), 4, False), ((1, 8, 6, 20), 3, True),
                  ((2, 12, 5, 33), 2, True), ((1, 40, 7, 24), 1, False)]


def _tol(dtype):
    """The scatter's float32 atomics add in another order than `index_add_`:
    within 1e-5 of the largest element in float32, one bf16 ulp there
    (2^-7) in bfloat16."""
    return 1e-5 if dtype == torch.float32 else 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,md,with_flow", DISP_BWD_CASES)
def test_displacement_backward_matches_plain_on_card(shape, md, with_flow, dtype):
    """The displacement volume's backward kernel against its plain version:
    dx bit for bit (the same float32 sums in the same order), dy bit for bit
    without a flow and within `_tol` with one (atomics); two launches give
    the same dx, and dy within the same tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import dicl as tdicl

    td = getattr(torch, dtype)
    x, y, flow = _disp_inputs(shape, with_flow, td, seed=5)
    B, C, h, w = shape
    S = 2 * md + 1
    g = torch.Generator(device="cuda").manual_seed(6)
    dout = torch.randn((B, S * S, 2 * C, h, w), device="cuda", generator=g).to(td)
    before = sweep_warp.DISPLACEMENT_BACKWARD.launches
    dx, dy = sweep_warp.displacement_volume_backward_cuda(dout, y, flow, md)
    dx2, dy2 = sweep_warp.displacement_volume_backward_cuda(dout, y, flow, md)
    torch.cuda.synchronize()
    assert sweep_warp.DISPLACEMENT_BACKWARD.launches == before + 2
    px, py = tdicl.displacement_volume_backward_plain(dout, x, y, flow, md)
    assert dx.dtype == dy.dtype == td and dx.shape == dy.shape == shape
    assert torch.equal(dx, px) and torch.equal(dx, dx2)
    if flow is None:
        assert torch.equal(dy, py) and torch.equal(dy, dy2)
    else:
        scale = float(py.float().abs().max())
        assert float((dy.float() - py.float()).abs().max()) <= _tol(td) * scale
        assert float((dy.float() - dy2.float()).abs().max()) <= _tol(td) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 9, 20), (1, 16, 8, 24)])
def test_displacement_backward_needs_finite_y_off_the_frame(shape, dtype):
    """Finite y is the backward kernel's precondition. Where y holds NaN or
    Inf on the frame's border and the flow sends samples off the frame,
    such a sample's warped value is NaN (the tap times its validity 0): the
    plain version keeps it, the kernel does not. So the kernel's dx equals
    the plain version's on y with its non-finite values zeroed (which flags
    every valid sample as y does, checked here) and differs from the plain
    version's on y; dy (which reads no value of y) is within `_tol` of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import dicl as tdicl

    td = getattr(torch, dtype)
    B, C, h, w = shape
    md, S = 3, 7
    x, y, flow = _disp_inputs(shape, True, td, seed=13)
    flow[:, 1, :2] = -2.0 * h                 # the top rows' samples above the frame
    y[:, 3, 2, w - 1] = float("nan")          # read by the right band's clamped taps
    y[:, 5, h - 1, w - 1] = float("inf")
    y[:, C - 1, 0, 4] = float("nan")          # read by the top rows' clamped taps
    y0 = torch.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0)
    g = torch.Generator(device="cuda").manual_seed(14)
    dout = torch.randn((B, S * S, 2 * C, h, w), device="cuda", generator=g).to(td)
    dx, dy = sweep_warp.displacement_volume_backward_cuda(dout, y, flow, md)
    px, py = tdicl.displacement_volume_backward_plain(dout, x, y, flow, md)
    px0, _ = tdicl.displacement_volume_backward_plain(dout, x, y0, flow, md)
    gx = torch.arange(w, device="cuda") + flow[:, 0]
    gy = torch.arange(h, device="cuda")[:, None] + flow[:, 1]
    valid = (gx >= 0) & (gx <= w - 1) & (gy >= 0) & (gy <= h - 1)
    yw = tdicl.warp_flow(y, flow, tdicl.bilinear_sample_plain)
    yw0 = tdicl.warp_flow(y0, flow, tdicl.bilinear_sample_plain)
    assert ((~valid) & yw.isnan().any(dim=1)).any()        # the case is exercised
    assert torch.equal(valid & (yw != 0).any(dim=1), valid & (yw0 != 0).any(dim=1))
    assert torch.equal(dx, px0) and not torch.equal(dx, px)
    scale = float(py.float().abs().max())
    assert float((dy.float() - py.float()).abs().max()) <= _tol(td) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_displacement_backward_replays_in_a_cuda_graph(dtype):
    """The backward (with a flow: the buffer's memset, the kernel and, in
    bfloat16, the cast) captured in a CUDA graph counts one launch at
    capture and none at replay; a replay on new inputs written in place
    gives an eager call's dx bit for bit and its dy within `_tol`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    shape, md = (2, 32, 32, 96), 3
    _, y, flow = _disp_inputs(shape, True, td, seed=9)
    g = torch.Generator(device="cuda").manual_seed(10)
    dout = torch.randn((2, 49, 64, 32, 96), device="cuda", generator=g).to(td)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sweep_warp.displacement_volume_backward_cuda(dout, y, flow, md)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = sweep_warp.DISPLACEMENT_BACKWARD.launches
    with torch.cuda.graph(graph):
        dx, dy = sweep_warp.displacement_volume_backward_cuda(dout, y, flow, md)
    assert sweep_warp.DISPLACEMENT_BACKWARD.launches == n + 1
    _, y2, flow2 = _disp_inputs(shape, True, td, seed=11)
    y.copy_(y2)
    flow.copy_(flow2)
    dout.copy_(torch.randn(dout.shape, device="cuda", generator=g).to(td))
    graph.replay()
    torch.cuda.synchronize()
    assert sweep_warp.DISPLACEMENT_BACKWARD.launches == n + 1
    ex, ey = sweep_warp.displacement_volume_backward_cuda(dout, y, flow, md)
    assert torch.equal(dx, ex)
    scale = float(ey.float().abs().max())
    assert scale > 0 and float((dy.float() - ey.float()).abs().max()) <= _tol(td) * scale


@pytest.mark.cuda
def test_displacement_volume_function_trains_through_the_kernels():
    """autograd through `models/dicl.py::displacement_volume` on the card:
    one forward and one backward launch, and the gradients of the plain
    composition (float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import dicl as tdicl

    x, y, flow = _disp_inputs((2, 16, 24, 40), True, torch.float32, seed=7)
    x.requires_grad_()
    y.requires_grad_()
    n = (sweep_warp.DISPLACEMENT.launches, sweep_warp.DISPLACEMENT_BACKWARD.launches)
    out = tdicl.displacement_volume(x, y, flow, 3)
    dout = torch.randn_like(out)
    got = torch.autograd.grad(out, (x, y), dout)
    assert (sweep_warp.DISPLACEMENT.launches - n[0],
            sweep_warp.DISPLACEMENT_BACKWARD.launches - n[1]) == (1, 1)
    want = torch.autograd.grad(tdicl.displacement_volume_plain(x, y, flow, 3), (x, y), dout)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    with pytest.raises(NotImplementedError, match="flow gradient"):
        tdicl.displacement_volume(x, y, flow.requires_grad_(), 3)


@pytest.mark.cuda
def test_displacement_volume_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, y, flow = _disp_inputs((1, 8, 6, 10), True, torch.float32)
    for args in ((x, y.bfloat16(), flow, 3), (x, y, flow.double(), 3), (x, y.cpu(), flow, 3),
                 (x, y, flow.cpu(), 3), (x, y[:, :4], flow, 3), (x, y, flow[:, :1], 3),
                 (x, y, flow, 5), (x.transpose(2, 3), y.transpose(2, 3), None, 3),
                 (torch.zeros(1, 65, 6, 10, device="cuda"),) * 2 + (flow, 3)):
        with torch.no_grad(), pytest.raises((ValueError, TypeError)):
            sweep_warp.displacement_volume_cuda(*args)
    with pytest.raises(NotImplementedError, match="flow gradient"):
        sweep_warp.displacement_volume_cuda(x, y, flow.requires_grad_(), 3)


# PWC-DC's five level shapes (f0, f1 at levels 6..2 of a 384x1280 pair), a
# batch of 2, and odd shapes: C = 40 splits unevenly across a cluster, C = 3
# takes the scalar staging path
B2_SHAPES = [((1, 6, 20, 196), 4), ((1, 12, 40, 128), 4), ((1, 24, 80, 96), 4),
             ((1, 48, 160, 64), 4), ((1, 96, 320, 32), 4), ((2, 24, 80, 96), 4),
             ((2, 13, 27, 40), 4), ((2, 13, 27, 40), 2), ((1, 5, 7, 3), 1)]


def _b2_inputs(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, device="cuda", generator=g),
            torch.randn(shape, device="cuda", generator=g))


def _outside(h, w, md):
    """(H, W, (2md+1)^2) True where (y+dy, x+dx) leaves the frame."""
    d = torch.arange(-md, md + 1, device="cuda")
    dy, dx = d.repeat_interleave(2 * md + 1), d.repeat(2 * md + 1)
    ys = torch.arange(h, device="cuda")[:, None, None] + dy
    xs = torch.arange(w, device="cuda")[None, :, None] + dx
    return (ys < 0) | (ys >= h) | (xs < 0) | (xs >= w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,md", B2_SHAPES)
def test_b2_kernel_matches_plain_on_card(shape, md):
    """B2 against its plain version on the card, at PWC-DC's five level
    shapes, a batch of 2 and odd shapes. Tolerance: float32 sums of <= 196
    products in another order, |kernel - plain| <= 1e-5 max|plain| + 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f0, f1 = _b2_inputs(shape, seed=1)
    before = local_corr.KERNEL.launches
    got = tcorr.local_correlation(f0, f1, md)
    torch.cuda.synchronize()
    assert local_corr.KERNEL.launches == before + 1
    ref = tcorr.local_correlation_plain(f0, f1, md)
    assert got.shape == ref.shape == shape[:3] + ((2 * md + 1) ** 2,)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape,md", B2_SHAPES)
def test_b2_kernel_is_deterministic(shape, md):
    """Two launches on the same inputs give the same bits: the channel split
    is reduced in a fixed rank order, with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f0, f1 = _b2_inputs(shape, seed=2)
    first = local_corr.local_correlation_cuda(f0, f1, md)
    second = local_corr.local_correlation_cuda(f0, f1, md)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 5, 7, 3), (1, 6, 20, 196)])
def test_b2_exact_zero_off_the_frame(shape):
    """Displacements that leave the frame give exactly 0, on the scalar
    staging path (C = 3) and across an 8-block channel split (C = 196),
    even where the frame's border holds large values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    md = 4
    assert (local_corr.plan(*shape, md).cluster > 1) == (shape[-1] == 196)
    f0, f1 = _b2_inputs(shape, seed=3)
    f1[:, [0, -1]] = 100.0
    f1[:, :, [0, -1]] = 100.0
    got = local_corr.local_correlation_cuda(f0, f1, md)
    torch.cuda.synchronize()
    outside = _outside(shape[1], shape[2], md).expand_as(got)
    assert bool((got[outside] == 0).all())
    assert bool((got[~outside] != 0).any())


@pytest.mark.cuda
def test_b2_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = torch.zeros(1, 8, 8, 4, device="cuda")
    for args in ((f.bfloat16(), f.bfloat16(), 4), (f, f[:, :4], 4), (f, f, 5),
                 (f.permute(0, 2, 1, 3), f, 4), (f, f.cpu(), 4)):
        with pytest.raises((ValueError, TypeError)):
            local_corr.local_correlation_cuda(*args)


# PWC-DC's warped levels 5..2 (b = 1, 384x1280) at their flow scales, a
# batch of 2 with odd H and W split across a cluster (C = 40) at md 4 and 2,
# and C = 3 on the scalar path; NHWC (B, H, W, C), JAX's public contract
WARPED_CASES = [((1, 12, 40, 128), 4, 0.625), ((1, 24, 80, 96), 4, 1.25),
                ((1, 48, 160, 64), 4, 2.5), ((1, 96, 320, 32), 4, 5.0),
                ((2, 13, 27, 40), 4, 1.0), ((2, 13, 27, 40), 2, 1.0), ((1, 5, 7, 3), 1, 1.0)]


def _warped_inputs(shape, dtype, seed):
    """f1 (B, H, W, C) float32, f2 of `dtype` and a flow (B, 2, H, W) of a
    few pixels with a band of samples sent off the frame."""
    B, H, W, C = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn(shape, device="cuda", generator=g)
    f2 = torch.randn(shape, device="cuda", generator=g).to(dtype)
    flow = (torch.rand(B, 2, H, W, device="cuda", generator=g) - 0.5) * 4
    flow[:, 0, :, -2:] = 2.0 * W
    return f1, f2, flow


def _warped_composition(f1, f2, flow, scale, md):
    """What PWC-DC launched before the fusion: coordinates, the gather, the
    float32 cast, B2."""
    B, H, W, _ = f2.shape
    grid = tcam.pixel_grid(H, W, torch.float32, f2.device)[:2]
    coords = (grid[None] + flow * scale).permute(0, 2, 3, 1).contiguous()
    warped = sweep_warp.bilinear_sample_cuda(f2, coords).float().contiguous()
    return local_corr.local_correlation_cuda(f1, warped, md)


def _same_split(B, C, H, W, md):
    """The warped correlation's mapping splits the channels as B2's does
    (the same cluster size): each rank's fmaf chain runs the same channels
    in the same order and the partial sums add in the same rank order."""
    return local_corr.warped_plan(B, C, H, W, md).cluster == local_corr.plan(B, H, W, C, md).cluster


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,md,scale", WARPED_CASES)
def test_warped_correlation_matches_composition_and_plain_on_card(shape, md, scale, dtype):
    """The NHWC warped correlation (the kernel between permutes) against
    the CUDA composition it replaces (the gather, the cast, B2) bit for bit
    where both mappings split the channels alike, and against its plain
    version within B2's tolerance, |kernel - plain| <= 1e-5 max|plain| +
    1e-6; two launches give the same bits. A bfloat16 f2 is refused there:
    bfloat16 features take the NCHW entry, in whose dtype the kernel
    computes (`test_warped_nchw_matches_plain_on_card`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f1, f2, flow = _warped_inputs(shape, getattr(torch, dtype), seed=12)
    if f2.dtype != torch.float32:
        with pytest.raises(TypeError, match="warped_correlation_nchw"):
            tcorr.warped_correlation(f1, f2, flow, scale, md)
        return
    before = local_corr.WARPED.launches
    got = tcorr.warped_correlation(f1, f2, flow, scale, md)
    again = tcorr.warped_correlation(f1, f2, flow, scale, md)
    torch.cuda.synchronize()
    assert local_corr.WARPED.launches == before + 2
    assert got.shape == shape[:3] + ((2 * md + 1) ** 2,) and got.dtype == torch.float32
    assert torch.equal(got, again)
    B, H, W, C = shape
    comp = _warped_composition(f1, f2, flow, scale, md)
    ref = tcorr.warped_correlation_plain(f1, f2, flow, scale, md)
    tol = 1e-5 * float(ref.abs().max()) + 1e-6
    assert float((got - ref).abs().max()) <= tol
    if _same_split(B, C, H, W, md):
        assert torch.equal(got, comp)
    else:
        assert float((got - comp).abs().max()) <= tol


# PWC-DC's warped levels 5..2 as it calls them, (B, C, H, W) and the flow's
# scale: a slice-2 pair (b = 1, 384x1280), a training step (b = 4, 256x768),
# then odd shapes (C split unevenly across a cluster at md 4 and 2, C = 3,
# rows not 16-byte aligned)
NCHW_CASES = [((1, 128, 12, 40), 4, 0.625), ((1, 96, 24, 80), 4, 1.25),
              ((1, 64, 48, 160), 4, 2.5), ((1, 32, 96, 320), 4, 5.0),
              ((4, 128, 8, 24), 4, 0.625), ((4, 96, 16, 48), 4, 1.25),
              ((4, 64, 32, 96), 4, 2.5), ((4, 32, 64, 192), 4, 5.0),
              ((2, 40, 13, 27), 4, 1.0), ((2, 40, 13, 27), 2, 1.0), ((1, 3, 5, 7), 1, 1.0)]


def _nchw_inputs(shape, dtype, seed, off_frame):
    """f1, f2 (B, C, H, W) channels-last, as PWC-DC's convolutions leave
    them, and a flow (B, 2, H, W) of a few pixels, all of `dtype`;
    `off_frame` sends bands of samples off the frame to the right and
    above, and lays the flow out channels-last (else contiguous: PWC-DC's
    up-sampled flows come either way)."""
    B, C, H, W = shape
    cl = torch.channels_last
    g = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn(shape, device="cuda", generator=g).to(dtype).contiguous(memory_format=cl)
    f2 = torch.randn(shape, device="cuda", generator=g).to(dtype).contiguous(memory_format=cl)
    flow = (torch.rand(B, 2, H, W, device="cuda", generator=g) - 0.5) * 6
    if off_frame:
        flow[:, 0, :, -max(W // 8, 1):] += 2.0 * W
        flow[:, 1, :max(H // 8, 1)] -= 1.5 * H
        flow = flow.contiguous(memory_format=cl)
    return f1, f2, flow.to(dtype)


def _bf16_ulp(x):
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _nchw_tolerance(ref):
    """B2's float32 tolerance, plus one bf16 ulp of a bfloat16 output (the
    kernel's and the plain version's sums may round to neighbouring
    values)."""
    tol = 1e-5 * float(ref.float().abs().max()) + 1e-6
    return tol + _bf16_ulp(ref) if ref.dtype == torch.bfloat16 else tol


def _span_before(f1, f2, flow, scale, md):
    """PWC-DC's span as it ran before the NCHW kernel, through CUDA
    kernels: the gather of f2 at grid + flow * scale, the float32 casts,
    B2 and the cast back to f1's dtype, NCHW."""
    f2h = f2.permute(0, 2, 3, 1).contiguous()
    corr = _warped_composition(f1.permute(0, 2, 3, 1).float().contiguous(), f2h, flow.float(),
                               scale, md)
    return corr.permute(0, 3, 1, 2).to(f1.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("off_frame", [False, True], ids=["flow", "off"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,md,scale", NCHW_CASES)
def test_warped_nchw_matches_plain_on_card(shape, md, scale, dtype, off_frame):
    """PWC-DC's entry on its channels-last features: one launch, the output
    channels-last in the features' dtype, within its plain version's
    tolerance; bit for bit
    against the span PWC-DC ran before (gather, casts, B2, cast back) where
    both mappings split the channels alike; two launches give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    f1, f2, flow = _nchw_inputs(shape, td, seed=31, off_frame=off_frame)
    before = local_corr.WARPED.launches
    got = tcorr.warped_correlation_nchw(f1, f2, flow, scale, md)
    again = local_corr.warped_correlation_cuda(f1, f2, flow, scale, md)
    torch.cuda.synchronize()
    assert local_corr.WARPED.launches == before + 2
    B, C, H, W = shape
    assert got.shape == (B, (2 * md + 1) ** 2, H, W) and got.dtype == td
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, again)
    ref = tcorr.warped_correlation_nchw_plain(f1, f2, flow, scale, md)
    assert bool(((got.float() - ref.float()).abs() <= _nchw_tolerance(ref)).all())
    was = _span_before(f1, f2, flow, scale, md)
    if _same_split(B, C, H, W, md):
        assert torch.equal(got, was)
    else:
        assert bool(((got.float() - was.float()).abs() <= _nchw_tolerance(was)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,md,scale", [NCHW_CASES[0], NCHW_CASES[3], NCHW_CASES[8]])
def test_warped_nchw_mappings_agree_on_card(shape, md, scale, dtype):
    """Every mapping the source instantiates gives its plain version's
    result within the plain tolerance; the FMA mappings without a cluster,
    whose chains run every channel in order in one block, give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    f1, f2, flow = _nchw_inputs(shape, td, seed=32, off_frame=True)
    B, C, H, W = shape
    op = local_corr.OPS.build().warped_correlation.default
    ref = tcorr.warped_correlation_nchw_plain(f1, f2, flow, scale, md)
    whole = op(f1, f2, flow, scale, md, 1, 1)
    for px in local_corr.WARPED_PIXELS:
        for cluster in (1, 2, 4, 8):
            if cluster > -(-C // 4):
                continue
            got = op(f1, f2, flow, scale, md, px, cluster)
            tol = _nchw_tolerance(ref)
            assert bool(((got.float() - ref.float()).abs() <= tol).all()), (px, cluster)
            if cluster == 1:
                assert torch.equal(got, whole), px


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pwc_flow_correlations_replay_in_a_cuda_graph(dtype):
    """PWC-DC's five correlations of a pair -- B2 at level 6 and the warped
    correlation at levels 5..2 on the network's NCHW features, all through
    operators -- captured in one CUDA graph count one launch each at capture
    and none at replay; a replay on new inputs written in place equals
    eager calls bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    level6 = list(_b2_inputs((1, 6, 20, 196), seed=13))
    warped = [list(_nchw_inputs(s, td, seed=14 + i, off_frame=False)) + [sc]
              for i, (s, _, sc) in enumerate(NCHW_CASES[:4])]

    def run():
        return ([local_corr.local_correlation_cuda(*level6, 4)]
                + [local_corr.warped_correlation_cuda(f1, f2, fl, sc, 4)
                   for f1, f2, fl, sc in warped])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = (local_corr.KERNEL.launches, local_corr.WARPED.launches)
    with torch.cuda.graph(graph):
        outs = run()
    assert (local_corr.KERNEL.launches - n[0], local_corr.WARPED.launches - n[1]) == (1, 4)
    for t, new in zip(level6, _b2_inputs((1, 6, 20, 196), seed=20)):
        t.copy_(new)
    for i, args in enumerate(warped):
        for t, new in zip(args[:3], _nchw_inputs(NCHW_CASES[i][0], td, seed=21 + i,
                                                 off_frame=True)):
            t.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    assert (local_corr.KERNEL.launches - n[0], local_corr.WARPED.launches - n[1]) == (1, 4)
    assert all(torch.equal(o, e) for o, e in zip(outs, run()))


@pytest.mark.cuda
def test_warped_correlation_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f1, f2, flow = _nchw_inputs((1, 4, 8, 8), torch.bfloat16, seed=15, off_frame=False)
    for args in ((f1.float(), f2, flow, 1.0, 4), (f1, f2.double(), flow, 1.0, 4),
                 (f1, f2[:, :2], flow, 1.0, 4), (f1, f2, flow[:, :1], 1.0, 4),
                 (f1, f2, flow.half(), 1.0, 4), (f1, f2, flow.cpu(), 1.0, 4),
                 (f1, f2.cpu(), flow, 1.0, 4), (f1.contiguous(), f2, flow, 1.0, 4),
                 (f1, f2, flow, 1.0, 5), (f1, f2, flow, 1.0, 0)):
        with pytest.raises((ValueError, TypeError)):
            local_corr.warped_correlation_cuda(*args)
    with torch.enable_grad(), pytest.raises(NotImplementedError, match="autograd function"):
        local_corr.warped_correlation_cuda(f1.requires_grad_(), f2, flow, 1.0, 4)


def _close(got, ref):
    """The backward kernels against their plain versions, to B2's
    tolerance (`_nchw_tolerance`): float32 sums of up to 81 products (and
    d f2's atomics) in another order, plus one bf16 ulp of a bf16
    gradient."""
    return bool(((got.float() - ref.float()).abs() <= _nchw_tolerance(ref)).all())


def _edge_flow(flow, scale):
    """The flow with samples exactly on the frame's edges and on integer
    positions: zero at the border pixels, and 5-pixel steps (a flow the
    scale multiplies exactly) on every third column."""
    flow = flow.clone()
    flow[..., [0, -1], :] = 0
    flow[..., :, [0, -1]] = 0
    steps = torch.tensor([-1.0, 0.0, 1.0], device=flow.device)[
        torch.arange(flow.shape[2] * flow.shape[3], device=flow.device) % 3].reshape(
            flow.shape[2:]) * (5.0 / scale)
    flow[:, :, 1:-1, 2:-1:3] = steps[1:-1, 2:-1:3].to(flow.dtype)
    return flow


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flow", "off", "edges"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,md,scale", NCHW_CASES[4:])
def test_warped_backward_matches_plain_on_card(shape, md, scale, dtype, kind):
    """The warped correlation's backward kernel through its autograd
    function at PWC-DC's training-step levels and odd shapes: one launch,
    d f1 and d f2 channels-last in the features' dtype, d flow in the
    flow's, within their plain versions' tolerance (`_close`),
    with flows that send samples off the frame and exactly onto its edges;
    d f1 and d flow bit-identical across two launches (gathers, and a fixed
    order over the channels), d f2 within the atomics' rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    f1, f2, flow = _nchw_inputs(shape, td, seed=41, off_frame=kind == "off")
    if kind == "edges":
        flow = _edge_flow(flow, scale)
    B, C, H, W = shape
    g = torch.Generator(device="cuda").manual_seed(42)
    dout = torch.randn(B, (2 * md + 1) ** 2, H, W, device="cuda", generator=g).to(td)
    dout = dout.contiguous(memory_format=torch.channels_last)
    leaves = [t.detach().clone().requires_grad_() for t in (f1, f2, flow)]
    before = (local_corr.WARPED.launches, local_corr.WARPED_BACKWARD.launches)
    out = tcorr.warped_correlation_nchw(*leaves, scale, md)
    got = torch.autograd.grad(out, leaves, dout)
    again = local_corr.warped_correlation_backward_cuda(f1, f2, flow, scale, dout, md)
    torch.cuda.synchronize()
    assert (local_corr.WARPED.launches - before[0],
            local_corr.WARPED_BACKWARD.launches - before[1]) == (1, 2)
    ref = tcorr.warped_correlation_nchw_backward_plain(f1, f2, flow, scale, dout, md)
    for name, a, b, w, t in zip(("d f1", "d f2", "d flow"), got, again, ref, (f1, f2, flow)):
        assert a.shape == t.shape and a.dtype == t.dtype, name
        assert _close(a, w), (name, float((a.float() - w.float()).abs().max()))
        assert torch.equal(a, b) if name != "d f2" else _close(b, w), name
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    assert got[1].is_contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warped_backward_reads_a_channel_slice_in_place(dtype):
    """PWC-DC's decoder concatenates the correlation with other channels,
    so the correlation's gradient arrives as a slice of a channels-last
    gradient: the kernel reads it at its pixel stride, with the same result
    as on a channels-last copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    shape, md, scale = NCHW_CASES[6]
    f1, f2, flow = _nchw_inputs(shape, td, seed=43, off_frame=True)
    B, C, H, W = shape
    g = torch.Generator(device="cuda").manual_seed(44)
    whole = torch.randn(B, 81 + C + 4, H, W, device="cuda", generator=g).to(td)
    whole = whole.contiguous(memory_format=torch.channels_last)
    part = whole[:, :81]
    assert not part.is_contiguous(memory_format=torch.channels_last)
    sliced = local_corr.warped_correlation_backward_cuda(f1, f2, flow, scale, part, md)
    copied = local_corr.warped_correlation_backward_cuda(
        f1, f2, flow, scale, part.contiguous(memory_format=torch.channels_last), md)
    torch.cuda.synchronize()
    assert torch.equal(sliced[0], copied[0]) and torch.equal(sliced[2], copied[2])
    assert _close(sliced[1], copied[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,md", B2_SHAPES)
def test_b2_backward_matches_plain_on_card(shape, md):
    """B2's backward kernel through `local_correlation`'s autograd function:
    one launch, d f0 and d f1 within the plain version's tolerance, bit
    for bit across two launches (both gathers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f0, f1 = _b2_inputs(shape, seed=45)
    g = torch.Generator(device="cuda").manual_seed(46)
    dout = torch.randn(*shape[:3], (2 * md + 1) ** 2, device="cuda", generator=g)
    a, b = f0.clone().requires_grad_(), f1.clone().requires_grad_()
    before = (local_corr.KERNEL.launches, local_corr.KERNEL_BACKWARD.launches)
    got = torch.autograd.grad(tcorr.local_correlation(a, b, md), (a, b), dout)
    again = local_corr.local_correlation_backward_cuda(f0, f1, dout, md)
    torch.cuda.synchronize()
    assert (local_corr.KERNEL.launches - before[0],
            local_corr.KERNEL_BACKWARD.launches - before[1]) == (1, 2)
    ref = tcorr.local_correlation_backward_plain(f0, f1, dout, md)
    for x, y, w in zip(got, again, ref):
        assert x.shape == w.shape and _close(x, w) and torch.equal(x, y)


@pytest.mark.cuda
def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = torch.zeros(1, 8, 8, 4, device="cuda")
    d = torch.zeros(1, 8, 8, 81, device="cuda")
    for args in ((f, f, d.bfloat16(), 4), (f, f, d[..., :25], 4), (f, f, d, 2),
                 (f.bfloat16(), f.bfloat16(), d, 4), (f, f, d.cpu(), 4)):
        with pytest.raises((ValueError, TypeError)):
            local_corr.local_correlation_backward_cuda(*args)
    f1, f2, flow = _nchw_inputs((1, 4, 8, 8), torch.bfloat16, seed=47, off_frame=False)
    dout = torch.zeros(1, 81, 8, 8, device="cuda", dtype=torch.bfloat16)
    for args in ((f1, f2, flow, 1.0, dout.float(), 4), (f1, f2, flow, 1.0, dout[:, :49], 4),
                 (f1, f2, flow, 1.0, dout, 3), (f1.contiguous(), f2, flow, 1.0, dout, 4),
                 (f1, f2, flow, 1.0, dout.cpu(), 4)):
        with pytest.raises((ValueError, TypeError)):
            local_corr.warped_correlation_backward_cuda(*args)


# the backward kernels' mappings: B2's at PWC-DC's level 6 of a training
# step (B, H, W, C) and ragged shapes, the warped one's at the training
# step's levels 5..2 (B, C, H, W) and ragged shapes
BWD_B2_CASES = [((4, 4, 12, 196), 4), ((2, 13, 27, 40), 4), ((1, 5, 7, 3), 1)]
BWD_WARPED_CASES = [NCHW_CASES[i] for i in (4, 5, 6, 7, 8, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,md", BWD_B2_CASES)
def test_b2_backward_every_mapping_on_card(shape, md):
    """B2's backward under every mapping of its grid
    (`local_corr.backward_mappings`, forced through the wrapper's `plan`):
    d f0 and d f1 within the plain version's tolerance, bit for bit across
    two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f0, f1 = _b2_inputs(shape, seed=49)
    g = torch.Generator(device="cuda").manual_seed(50)
    dout = torch.randn(*shape[:3], (2 * md + 1) ** 2, device="cuda", generator=g)
    ref = tcorr.local_correlation_backward_plain(f0, f1, dout, md)
    B, H, W, C = shape
    maps = local_corr.backward_mappings(B, C, H, W, md, 4, False)
    assert len(maps) > 1
    for p in maps:
        got = local_corr.local_correlation_backward_cuda(f0, f1, dout, md, plan=p)
        again = local_corr.local_correlation_backward_cuda(f0, f1, dout, md, plan=p)
        torch.cuda.synchronize()
        for x, y, w in zip(got, again, ref):
            assert _close(x, w), (p.key, float((x - w).abs().max()))
            assert torch.equal(x, y), p.key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,md,scale", BWD_WARPED_CASES)
def test_warped_backward_every_mapping_on_card(shape, md, scale, dtype):
    """The warped correlation's backward under every mapping of its grid
    (tiles, channel groups of 1 to 8 cluster ranks), on a flow that sends
    samples off the frame and a dout sliced from a channels-last gradient,
    as PWC-DC's decoder hands it: d f1, d f2 and d flow within the plain
    version's tolerance; d f1 and d flow bit for bit across two launches
    (the cluster adds its ranks' d flow in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    td = getattr(torch, dtype)
    f1, f2, flow = _nchw_inputs(shape, td, seed=51, off_frame=True)
    B, C, H, W = shape
    S2 = (2 * md + 1) ** 2
    g = torch.Generator(device="cuda").manual_seed(52)
    whole = torch.randn(B, S2 + C + 4, H, W, device="cuda", generator=g).to(td)
    dout = whole.contiguous(memory_format=torch.channels_last)[:, :S2]
    ref = tcorr.warped_correlation_nchw_backward_plain(f1, f2, flow, scale, dout, md)
    maps = local_corr.backward_mappings(B, C, H, W, md, td.itemsize, True)
    assert len(maps) > 1
    for p in maps:
        got = local_corr.warped_correlation_backward_cuda(f1, f2, flow, scale, dout, md, plan=p)
        again = local_corr.warped_correlation_backward_cuda(f1, f2, flow, scale, dout, md, plan=p)
        torch.cuda.synchronize()
        for name, a, b, w in zip(("d f1", "d f2", "d flow"), got, again, ref):
            assert _close(a, w), (p.key, name, float((a.float() - w.float()).abs().max()))
            assert torch.equal(a, b) if name != "d f2" else _close(b, w), (p.key, name)


@pytest.mark.cuda
def test_backward_operators_refuse_mappings_the_kernel_does_not_take():
    """A tile width that is no multiple of the run, too many threads, a run
    other than 1, 2 or 4, slots that are no power of two, and with a flow
    more channel groups than a cluster holds: refused by the operators'
    checks, never launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ops = local_corr.OPS.build()
    f = torch.zeros(1, 8, 8, 16, device="cuda")
    d = torch.zeros(1, 8, 8, 81, device="cuda")
    for th, tw, run, ns in ((4, 6, 4, 1), (8, 32, 4, 16), (0, 8, 4, 1), (4, 8, 3, 1),
                            (4, 8, 4, 3)):
        with pytest.raises(ValueError):
            ops.local_correlation_backward(f, f, d, 4, th, tw, run, ns)
    f1, f2, flow = _nchw_inputs((1, 128, 8, 8), torch.bfloat16, seed=53, off_frame=False)
    dout = torch.zeros(1, 81, 8, 8, device="cuda", dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="cluster"):
        ops.warped_correlation_backward(f1, f2, flow, 1.0, dout, 4, 4, 8, 4, 1)


def _rigid_correspondences(seed):
    """Normalized correspondences of a rigid scene (f64, on the CPU) with
    1e-5 noise and 20% outliers, and 128 minimal samples."""
    from deep_sfm_revisited_tpu_torch.ops import flow_ops, rotations

    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    K = torch.tensor([[80.0, 0, 64.0], [0, 80.0, 48.0], [0, 0, 1]], dtype=f64)[None]
    K_inv = torch.linalg.inv(K)
    R = rotations.angle_to_matrix((torch.rand(3, generator=g, dtype=f64) - 0.5) * 0.1)
    t = torch.rand(3, generator=g, dtype=f64) - 0.5
    t[2] = t[2].abs() + 0.3
    pose = torch.cat([R, (t / t.norm())[:, None]], dim=1)[None]
    depth = 5.0 + 3.0 * torch.rand((1, 96, 128), generator=g, dtype=f64)
    x1, x2 = flow_ops.sample_correspondences(tcam.pose2flow(depth, pose, K, K_inv), K_inv,
                                             512, margin=10)
    x2 = x2 + 1e-5 * torch.randn(x2.shape, generator=g, dtype=f64)
    bad = torch.rand(x2.shape[:2], generator=g) < 0.2
    x2 = torch.where(bad[..., None], (torch.rand(x2.shape, generator=g, dtype=f64) - 0.5) * 1.2, x2)
    return x1, x2, torch.randint(0, 512, (1, 128, 5), generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("solve", ["float64", "float32"])
def test_ransac_on_card_matches_cpu(solve):
    """The pose engine on the card against the same engine on the CPU, same
    correspondences and minimal samples, two-stage vote on, well-posed
    scenes: equal inlier counts and P to 1e-5 (f32 candidates; f64 ones
    agree to ~1e-11). On a degenerate flow the vote is not stable across
    devices, which is why the scenes are well posed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.ops import essential

    kw = dict(num_hypotheses=128, ransac_iter=1, threshold=1e-4, polish=True,
              polish_iters=5, solve_dtype=getattr(torch, solve), score_subset=128,
              score_topk=512)
    for seed in range(4):
        x1, x2, idx = _rigid_correspondences(seed)
        on_cpu = essential.ransac_pose(x1, x2, sample_idx=idx, **kw)
        on_card = essential.ransac_pose(x1.cuda(), x2.cuda(), sample_idx=idx.cuda(), **kw)
        assert int(on_card["inliers"][0]) == int(on_cpu["inliers"][0])
        torch.testing.assert_close(on_card["P"].cpu(), on_cpu["P"], rtol=0, atol=1e-5)


# RAFT's lookup (R1) and its backward (R2): the eval pair's shape (384x1280
# at 1/8, b = 1), the training step's (256x768 crops at 1/8, b = 4), and
# ragged shapes whose coarse rows are no whole number of 16-byte units
RAFT_CASES = [(1, 48, 160), (4, 32, 96), (2, 9, 13), (1, 8, 11)]


def _raft_inputs(B, h, w, level_dtype, seed=0):
    """A bf16 (or float32) pyramid pooled as RAFT pools it, and coordinates
    in and off the frame, beyond the clip and on each clip bound."""
    from deep_sfm_revisited_tpu_torch.models import raft as traft

    g = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn(B, 64, h, w, device="cuda", generator=g)
    f2 = torch.randn(B, 64, h, w, device="cuda", generator=g)
    levels = [lv.to(level_dtype) for lv in traft.correlation_pyramid(f1, f2, 4)]
    coords = torch.rand(B, h, w, 2, device="cuda", generator=g) * torch.tensor(
        [w + 24.0, h + 24.0], device="cuda") - 12.0
    flat = coords.view(-1, 2)
    n = 0
    for i, lv in enumerate(levels):
        for k, size in ((0, lv.shape[2]), (1, lv.shape[1])):
            for v in (-6.0 * 2 ** i, (size + 5.0) * 2 ** i):
                if n < flat.shape[0]:
                    flat[n, k] = v
                    n += 1
    return levels, coords


@pytest.mark.cuda
@pytest.mark.parametrize("level_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RAFT_CASES)
def test_raft_lookup_matches_plain_on_card(shape, out_dtype, level_dtype):
    """R1 bit for bit its plain version on the card (both round op by op,
    without FMA contraction, in one order), cast to the output dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import raft as traft
    from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

    od, ld = getattr(torch, out_dtype), getattr(torch, level_dtype)
    levels, coords = _raft_inputs(*shape, ld)
    before = raft_lookup.LOOKUP.launches
    got = raft_lookup.raft_lookup_cuda(coords, levels, 4, od)
    torch.cuda.synchronize()
    assert raft_lookup.LOOKUP.launches == before + 1
    assert got.dtype == od and got.shape == (*shape, 324) and got.is_contiguous()
    ref = traft.lookup_correlation_plain(levels, coords, 4).to(od)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.cuda
def test_raft_lookup_levels_off_a_word_match_plain_on_card():
    """R1 bit for bit at the eval shape and at one whose Q (234) is no
    multiple of the queries a block (a tail block), bf16 levels with the
    first level one element off a 4-byte word (its rows' phase flips)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import raft as traft
    from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

    assert 234 % raft_lookup.R1_QUERIES
    for shape in ((1, 48, 160), (2, 9, 13)):
        levels, coords = _raft_inputs(*shape, torch.bfloat16, seed=4)
        Q = shape[0] * shape[1] * shape[2]
        odd = torch.empty(Q * levels[0][0].numel() + 1, dtype=torch.bfloat16, device="cuda")
        levels[0] = odd[1:].view_as(levels[0]).copy_(levels[0])
        for od in (torch.bfloat16, torch.float32):
            got = raft_lookup.raft_lookup_cuda(coords, levels, 4, od)
            ref = traft.lookup_correlation_plain(levels, coords, 4).to(od)
            torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("level_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dout_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RAFT_CASES)
def test_raft_lookup_backward_matches_plain_on_card(shape, dout_dtype, level_dtype):
    """R2 adds each level's gradient into an accumulator that already holds
    values: bit for bit the accumulating plain version from the same start
    (float32 terms added in one order, rounded to the levels' dtype, added
    to the accumulator in float32 and rounded again; elements no tap
    reaches untouched); the coordinates' gradient to 1e-5 of its largest
    value (sums of 81 products in a fixed order), the same from a second
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import raft as traft
    from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

    ld = getattr(torch, level_dtype)
    levels, coords = _raft_inputs(*shape, ld, seed=1)
    g = torch.Generator(device="cuda").manual_seed(2)
    dout = torch.randn(*shape, 324, device="cuda", generator=g).to(getattr(torch, dout_dtype))
    start = [torch.randn(lv.shape, device="cuda", generator=g).to(ld) for lv in levels]
    acc = [a.clone() for a in start]
    before = raft_lookup.LOOKUP_BACKWARD.launches
    dc = raft_lookup.raft_lookup_backward_cuda(coords, levels, dout, 4, acc)
    torch.cuda.synchronize()
    assert raft_lookup.LOOKUP_BACKWARD.launches == before + 1
    want = [a.clone() for a in start]
    wdc = traft.lookup_correlation_backward_accumulate_plain(levels, coords, dout, 4, want)
    for got, w in zip(acc, want):
        assert got.dtype == ld and torch.equal(_bits(got), _bits(w))
    assert dc.dtype == torch.float32 and dc.shape == coords.shape
    torch.testing.assert_close(dc, wdc, rtol=0, atol=1e-5 * float(wdc.abs().max()))
    again = [a.clone() for a in start]
    assert torch.equal(raft_lookup.raft_lookup_backward_cuda(coords, levels, dout, 4, again), dc)


@pytest.mark.cuda
@pytest.mark.parametrize("calls", [2, 12])
@pytest.mark.parametrize("shape", [(4, 32, 96), (2, 9, 13)])
def test_raft_lookup_backward_adds_across_calls_on_card(shape, calls):
    """`calls` launches of R2 (the iterations of one backward pass, last
    first) into one zero-filled accumulator a level: bit for bit the dense
    plain gradients added in bf16 in that order (what autograd's sum gave);
    at the training step's shape and at one with a tail block (Q = 234) and
    levels of odd size (updated element by element)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import raft as traft
    from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

    levels, coords = _raft_inputs(*shape, torch.bfloat16, seed=5)
    g = torch.Generator(device="cuda").manual_seed(6)
    acc = [torch.zeros_like(lv) for lv in levels]
    dense = None
    for i in range(calls):
        c = coords + 0.37 * i
        d = torch.randn(*shape, 324, device="cuda", generator=g).to(torch.bfloat16)
        raft_lookup.raft_lookup_backward_cuda(c, levels, d, 4, acc)
        dl, _ = traft.lookup_correlation_backward_plain(levels, c, d, 4)
        dense = dl if dense is None else [a + b for a, b in zip(dense, dl)]
    torch.cuda.synchronize()
    for got, want in zip(acc, dense):
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_raft_lookup_autograd_launches_both_kernels():
    """`RaftLookupFn` on CUDA tensors: one R1 launch forward, one R2 launch
    backward into a zero-filled accumulator, its gradients R2's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import raft as traft
    from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

    levels, coords = _raft_inputs(2, 16, 24, torch.bfloat16, seed=3)
    levels = [lv.requires_grad_() for lv in levels]
    coords = coords.requires_grad_()
    f0, b0 = raft_lookup.LOOKUP.launches, raft_lookup.LOOKUP_BACKWARD.launches
    out = traft.lookup_correlation(levels, coords, 4, torch.bfloat16)
    dout = torch.randn_like(out)
    grads = torch.autograd.grad(out, [coords, *levels], dout)
    torch.cuda.synchronize()
    assert raft_lookup.LOOKUP.launches == f0 + 1
    assert raft_lookup.LOOKUP_BACKWARD.launches == b0 + 1
    acc = [torch.zeros_like(lv) for lv in levels]
    dc = raft_lookup.raft_lookup_backward_cuda(coords.detach(), [lv.detach() for lv in levels],
                                               dout, 4, acc)
    assert torch.equal(grads[0], dc)
    for got, want in zip(grads[1:], acc):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_raft_training_step_on_card_launches_r2_into_one_pyramid_gradient():
    """A 3-iteration RAFT training step on the card: R1 and R2 three times
    each, the pyramid's gradient finite and non-zero, every parameter
    reached."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.models import raft as traft
    from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

    cfg = SfMConfig.kitti().override(**{"flow.estimator": "RAFT", "flow.raft_iters_train": 3})
    torch.manual_seed(0)
    net = traft.RAFT(cfg.flow).cuda().train()
    pair = torch.rand((2, 64, 96, 6), device="cuda") * 2 - 1
    f0, b0 = raft_lookup.LOOKUP.launches, raft_lookup.LOOKUP_BACKWARD.launches
    with torch.autocast("cuda", torch.bfloat16):
        flows, _ = net(pair, all_iters=True)
    flows.float().abs().mean().backward()
    torch.cuda.synchronize()
    assert (raft_lookup.LOOKUP.launches - f0, raft_lookup.LOOKUP_BACKWARD.launches - b0) == (3, 3)
    for k, p in net.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, k


class _DenseCardLookupFn(torch.autograd.Function):
    """The lookup as the port ran it before the accumulators: R1 forward,
    and a backward that launches R2 into fresh zero accumulators on every
    call and returns them as dense level gradients, which autograd adds."""

    @staticmethod
    def forward(ctx, coords, radius, out_dtype, acc, *levels):
        from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

        ctx.radius = radius
        ctx.save_for_backward(coords, *levels)
        return raft_lookup.raft_lookup_cuda(coords, levels, radius, out_dtype)

    @staticmethod
    def backward(ctx, dout):
        from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

        coords, *levels = ctx.saved_tensors
        dense = [torch.zeros_like(lv) for lv in levels]
        dc = raft_lookup.raft_lookup_backward_cuda(coords, levels, dout.contiguous(), ctx.radius,
                                                   dense)
        return (dc, None, None, None, *dense)


def _raft_card_step(iters=3):
    """Parameter and pyramid gradients of a RAFT training step on the card
    (float32, b = 2, 64x96, the `all_iters` stack under a sequence loss),
    and the R1 and R2 launches it made."""
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.models import raft as traft
    from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

    cfg = SfMConfig.kitti().override(**{"flow.estimator": "RAFT",
                                        "flow.raft_iters_train": iters})
    torch.manual_seed(0)
    net = traft.RAFT(cfg.flow).cuda().train()
    g = torch.Generator().manual_seed(1)
    pair = (torch.rand((2, 64, 96, 6), generator=g) * 2 - 1).cuda()
    gt = (torch.randn((2, 64, 96, 2), generator=g) + 2).cuda()
    pyramids, real = [], traft.correlation_pyramid

    def keep(*a, **kw):
        levels = real(*a, **kw)
        for lv in levels:
            lv.retain_grad()
        pyramids.append(levels)
        return levels

    f0, b0 = raft_lookup.LOOKUP.launches, raft_lookup.LOOKUP_BACKWARD.launches
    traft.correlation_pyramid = keep
    try:
        flows, _ = net(pair, all_iters=True)
    finally:
        traft.correlation_pyramid = real
    n = flows.shape[0]
    loss = sum(0.8 ** (n - i - 1) * (flows[i] - gt).abs().mean() for i in range(n))
    loss.backward()
    torch.cuda.synchronize()
    launches = (raft_lookup.LOOKUP.launches - f0, raft_lookup.LOOKUP_BACKWARD.launches - b0)
    return ({k: p.grad for k, p in net.named_parameters()},
            [lv.grad for lv in pyramids[0]], launches)


@pytest.mark.cuda
def test_raft_step_gradients_are_the_dense_paths_bit_for_bit_on_card(monkeypatch):
    """A 3-iteration RAFT training step on the card through `PyramidGrad`
    (R2 adding into one pyramid gradient, lookup 0 handing it to autograd)
    gives the pyramid's and every parameter's gradient bit for bit as the
    dense path (R2 into fresh zero accumulators each call, autograd adding
    them), both with deterministic cuDNN; the step run twice gives the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import raft as traft

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    grads, pyr, launches = _raft_card_step()
    assert launches == (3, 3)
    again, pyr2, _ = _raft_card_step()
    monkeypatch.setattr(traft, "RaftLookupFn", _DenseCardLookupFn)
    want, wpyr, dense_launches = _raft_card_step()
    assert dense_launches == (3, 3)
    assert set(grads) == set(want)
    for i, (a, a2, b) in enumerate(zip(pyr, pyr2, wpyr)):
        assert a.dtype == torch.bfloat16 and a.abs().max() > 0
        assert torch.equal(_bits(a), _bits(a2)), f"pyramid level {i}, run twice"
        assert torch.equal(_bits(a), _bits(b)), f"pyramid level {i}"
    for k, v in grads.items():
        assert torch.isfinite(v).all() and v.abs().max() > 0, k
        assert torch.equal(v, again[k]), f"{k}, run twice"
        assert torch.equal(v, want[k]), k


@pytest.mark.cuda
def test_raft_lookup_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

    levels, coords = _raft_inputs(1, 8, 12, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        raft_lookup.raft_lookup_cuda(coords.cpu(), levels, 4, torch.float32)
    with pytest.raises(TypeError):
        raft_lookup.raft_lookup_cuda(coords.double(), levels, 4, torch.float32)
    with pytest.raises(ValueError, match="radius"):
        raft_lookup.raft_lookup_cuda(coords, levels, 5, torch.float32)
    with pytest.raises(TypeError):
        raft_lookup.raft_lookup_cuda(coords, [levels[0].float(), *levels[1:]], 4,
                                     torch.float32)
    with pytest.raises(ValueError, match="levels"):
        raft_lookup.raft_lookup_cuda(coords, levels + levels[:1], 4, torch.float32)
    with pytest.raises(TypeError):
        raft_lookup.raft_lookup_cuda(coords, levels, 4, torch.float64)
    acc = [torch.zeros_like(lv) for lv in levels]
    with pytest.raises(ValueError, match="dout"):
        raft_lookup.raft_lookup_backward_cuda(coords, levels,
                                              torch.zeros(1, 8, 12, 81, device="cuda"), 4, acc)
    dout = torch.zeros(1, 8, 12, 324, device="cuda")
    with pytest.raises(ValueError, match="accumulator"):
        raft_lookup.raft_lookup_backward_cuda(coords, levels, dout, 4, acc[:-1])
    with pytest.raises(ValueError, match="accumulator"):
        raft_lookup.raft_lookup_backward_cuda(coords, levels, dout, 4,
                                              [torch.zeros_like(lv).float() for lv in levels])


# REGNet's sweep correlation (K1) and its backward (K2): (B, D, H, W, C, n)
# with n^3 poses: an eval pair's shape (KITTI's 384x1280 at 1/4, 128 planes,
# 125 poses), batch 2 with odd H and W and C = 8 (one 16-byte chunk in bf16),
# a pose that puts the near planes behind the camera, one that pushes most
# samples out of the frame
CORR_CASES = [((1, 128, 96, 320, 32, 5), "forward"), ((2, 7, 13, 27, 8, 3), "forward"),
              ((1, 16, 24, 40, 32, 3), "behind"), ((1, 16, 24, 40, 32, 3), "outward")]
CORR_BWD_CASES = [((2, 32, 24, 48, 32, 5), "forward"), ((2, 7, 13, 27, 8, 3), "forward"),
                  ((1, 16, 24, 40, 32, 3), "behind"), ((1, 16, 24, 40, 32, 3), "outward")]


def _corr_inputs(shape, pose_kind, dtype, seed=0):
    """ref, tgt, depths, M (B, S, 3, 3), Kt (B, S, 3) on the card: the sweep
    inputs' features and pose, REGNet's pose grid around it."""
    from deep_sfm_revisited_tpu_torch.models import depth_alternates as tda
    from deep_sfm_revisited_tpu_torch.ops import rotations

    B, D, H, W, C, n = shape
    ref, tgt, depths, _, _ = _sweep_inputs((B, D, H, W, C), pose_kind, dtype, seed)
    f = 718.856 / 4 * W / 320
    K = torch.tensor([[f, 0, W / 2 - 0.4], [0, f, H / 2 + 0.3], [0, 0, 1]], device="cuda")
    R = rotations.angle_to_matrix(torch.tensor([0.01, -0.02, 0.005], device="cuda"))
    t = torch.tensor(SWEEP_T[pose_kind], device="cuda")[:, None]
    poses = tda.sample_pose_grid(torch.cat([R, t], dim=1).expand(B, 3, 4), n, 0.12, 0.27)
    S = poses.shape[1]
    M, Kt = tcam.sweep_matrices(poses.reshape(B * S, 3, 4), K.expand(B * S, 3, 3),
                                torch.linalg.inv(K).expand(B * S, 3, 3))
    return ref, tgt, depths, M.reshape(B, S, 3, 3), Kt.reshape(B, S, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,pose_kind", CORR_CASES)
def test_sweep_correlation_matches_plain_on_card(shape, pose_kind, dtype):
    """K1 against its plain version on the card, bit for bit (both sum a
    sample's channels in order, op by op without FMA), with
    channels-last-3d strides; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_corr

    ref, tgt, depths, M, Kt = _corr_inputs(shape, pose_kind, getattr(torch, dtype))
    before = sweep_corr.CORRELATION.launches
    got = sweep_corr.sweep_correlation_cuda(ref, tgt, depths, M.reshape(-1, 3, 3),
                                            Kt.reshape(-1, 3))
    torch.cuda.synchronize()
    assert sweep_corr.CORRELATION.launches == before + 1
    want = tcam.sweep_correlation_plain(ref, tgt, depths, M, Kt)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if pose_kind != "forward":
        assert (got == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,pose_kind", CORR_BWD_CASES)
def test_sweep_correlation_backward_matches_plain_on_card(shape, pose_kind, dtype):
    """K2 against its plain version on the card: both gradients within 1e-5
    of their largest element (the sums run in other orders, d tgt's with
    atomics), plus one bf16 ulp of a bf16 gradient; d ref the same bits on
    every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_corr

    ref, tgt, depths, M, Kt = _corr_inputs(shape, pose_kind, getattr(torch, dtype))
    B, D, H, W, C, n = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.randn(B, n ** 3, D, H, W, device="cuda", generator=gen).contiguous(
        memory_format=torch.channels_last_3d)
    before = sweep_corr.CORRELATION_BACKWARD.launches
    args = (ref, tgt, depths, M.reshape(-1, 3, 3), Kt.reshape(-1, 3))
    dref, dtgt = sweep_corr.sweep_correlation_backward_cuda(g, *args)
    dref2, _ = sweep_corr.sweep_correlation_backward_cuda(g, *args)
    torch.cuda.synchronize()
    assert sweep_corr.CORRELATION_BACKWARD.launches == before + 2
    assert torch.equal(dref, dref2)
    want = tcam.sweep_correlation_backward_plain(g, ref, tgt, depths, M, Kt)
    for got, ref_ in zip((dref, dtgt), want):
        assert got.dtype == ref_.dtype and got.shape == ref_.shape
        tol = _nchw_tolerance(ref_)
        assert bool(((got.float() - ref_.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_sweep_correlation_autograd_launches_both_kernels():
    """`sweep_correlation` under autograd on the card: K1 forward, K2
    backward, the gradients the wrappers give."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.models import depth_alternates as tda
    from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_corr

    B, D, H, W, C = 1, 8, 12, 20, 32
    ref, tgt, depths, _, _ = _sweep_inputs((B, D, H, W, C), "forward", torch.bfloat16)
    K = torch.tensor([[20.0, 0, 9.6], [0, 20.0, 6.3], [0, 0, 1]], device="cuda")[None]
    pose = torch.tensor([[1.0, 0, 0, 0.1], [0, 1, 0, 0], [0, 0, 1, 0.9]], device="cuda")[None]
    poses = tda.sample_pose_grid(pose, 3, 0.12, 0.27)
    r, t = ref.clone().requires_grad_(), tgt.clone().requires_grad_()
    k1, k2 = sweep_corr.CORRELATION.launches, sweep_corr.CORRELATION_BACKWARD.launches
    out = tcam.sweep_correlation(r, t, depths, poses, K, torch.linalg.inv(K))
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert (sweep_corr.CORRELATION.launches, sweep_corr.CORRELATION_BACKWARD.launches) == \
        (k1 + 1, k2 + 1)
    M, Kt = tcam.sweep_matrices(poses.reshape(-1, 3, 4), K.expand(27, 3, 3),
                                torch.linalg.inv(K).expand(27, 3, 3))
    dref, _ = sweep_corr.sweep_correlation_backward_cuda(
        g.contiguous(memory_format=torch.channels_last_3d), ref, tgt, depths, M, Kt)
    assert torch.equal(r.grad, dref) and t.grad.dtype == torch.bfloat16


@pytest.mark.cuda
def test_sweep_correlation_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_corr

    # batch 2, so that 53 poses are no whole number a batch item
    ref, tgt, depths, M, Kt = _corr_inputs((2, 4, 8, 12, 32, 3), "forward", torch.float32)
    M, Kt = M.reshape(-1, 3, 3), Kt.reshape(-1, 3)
    with pytest.raises(ValueError, match="CUDA"):
        sweep_corr.sweep_correlation_cuda(ref.cpu(), tgt.cpu(), depths.cpu(), M.cpu(), Kt.cpu())
    with pytest.raises(TypeError):
        sweep_corr.sweep_correlation_cuda(ref.double(), tgt.double(), depths, M, Kt)
    with pytest.raises(TypeError):
        sweep_corr.sweep_correlation_cuda(ref, tgt.bfloat16(), depths, M, Kt)
    with pytest.raises(ValueError, match="multiple of 16"):   # 6 float32: 24-byte rows
        sweep_corr.sweep_correlation_cuda(ref[..., :6].contiguous(), tgt[..., :6].contiguous(),
                                          depths, M, Kt)
    with pytest.raises(ValueError, match="B S"):
        sweep_corr.sweep_correlation_cuda(ref, tgt, depths, M[:-1], Kt[:-1])
    g = torch.zeros(2, 27, 4, 8, 12, device="cuda")
    with pytest.raises(ValueError, match="channels-last-3d"):
        sweep_corr.sweep_correlation_backward_cuda(g, ref, tgt, depths, M, Kt)
