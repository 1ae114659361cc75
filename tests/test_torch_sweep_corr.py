"""REGNet's sweep correlation in the port against the JAX package.

The port computes mean(ref * warped, -1) over every pose hypothesis and plane
depth in one call (`ops/camera.py::sweep_correlation`: kernel K1 on the card,
its plain version `sweep_correlation_plain` on the CPU) and its gradient with
respect to both feature maps (K2; `sweep_correlation_backward_plain`). The
JAX package builds it as `mean(ref[:, None, None] * _scaled_sweep(tgt, ...),
-1)` (`models/depth_alternates.py:91-107, 248-252`). Inputs are made with
numpy from a seed; the poses are `sample_pose_grid`'s of a base pose, as
REGNet samples them.

Tolerances: float64 1e-12 (both sides read float32 coordinates, as the
gather casts them, and compute the rest in float64); float32 1e-5 of the
largest magnitude, over samples whose JAX coordinate lies more than 1e-3 px
from the frame's edge (coordinates come from two formulas one ulp apart,
which flips the in/out decision on the edge; those samples stay under 1%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.models import depth_alternates as jda
from deep_sfm_revisited_tpu.ops import camera as jcam
from deep_sfm_revisited_tpu_torch.models import depth_alternates as tda
from deep_sfm_revisited_tpu_torch.ops import camera as tcam
from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_corr

torch.set_num_threads(1)

# (B, D, H, W, C), the base pose's translation, the grid size n (n^3 poses):
# forward motion; t_z < 0 puts the near planes behind the camera; a sideways
# t pushes most samples out of the frame
CASES = [((1, 6, 10, 16, 8), (0.2, 0.05, 0.9), 3), ((2, 4, 9, 13, 4), (0.1, -0.1, -2.0), 3),
         ((1, 5, 8, 12, 8), (4.0, 0.2, 0.1), 3)]
IDS = ["forward", "behind", "outward"]


def _scene(case, dtype, seed=0):
    (B, D, H, W, C), t, n = case
    rng = np.random.RandomState(seed)
    K = np.broadcast_to(np.array([[0.9 * W, 0, W / 2 - 0.3], [0, 0.9 * W, H / 2 + 0.2],
                                  [0, 0, 1]]), (B, 3, 3))
    a = rng.uniform(-0.05, 0.05, 3)
    U, _, Vt = np.linalg.svd(np.array([[1, -a[2], a[1]], [a[2], 1, -a[0]], [-a[1], a[0], 1]]))
    pose = np.broadcast_to(np.concatenate([U @ Vt, np.reshape(t, (3, 1))], 1), (B, 3, 4))
    # REGNet's grid of the float32 pose (std_rot 0.12, std_tr 0.27 for n > 1)
    poses = np.asarray(jda.sample_pose_grid(jnp.asarray(pose, jnp.float32), n, 0.12, 0.27))
    return dict(ref=rng.randn(B, H, W, C).astype(dtype), tgt=rng.randn(B, H, W, C).astype(dtype),
                depths=(D / np.arange(1, D + 1)).astype(dtype), poses=poses.astype(dtype),
                K=K.astype(dtype), K_inv=np.linalg.inv(K).astype(dtype),
                g=rng.randn(B, poses.shape[1], D, H, W).astype(dtype))


def _jax_corr(s):
    j = {k: jnp.asarray(v) for k, v in s.items()}

    def corr(ref, tgt):
        vol = jda._scaled_sweep(tgt, j["depths"], j["poses"], j["K"], j["K_inv"])
        return jnp.mean(ref[:, None, None] * vol, axis=-1)

    out, vjp = jax.vjp(corr, j["ref"], j["tgt"])
    return np.asarray(out), [np.asarray(v) for v in vjp(j["g"])]


def _matrices(t):
    B, S = t["poses"].shape[:2]
    M, Kt = tcam.sweep_matrices(t["poses"].reshape(B * S, 3, 4),
                                t["K"].repeat_interleave(S, 0), t["K_inv"].repeat_interleave(S, 0))
    return M.reshape(B, S, 3, 3), Kt.reshape(B, S, 3)


def _port(s):
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    M, Kt = _matrices(t)
    out = tcam.sweep_correlation_plain(t["ref"], t["tgt"], t["depths"], M, Kt)
    dref, dtgt = tcam.sweep_correlation_backward_plain(t["g"], t["ref"], t["tgt"], t["depths"],
                                                       M, Kt)
    return out, dref, dtgt


def _near_edge(s):
    B, S = s["poses"].shape[:2]
    H, W = s["ref"].shape[1:3]
    f = {k: jnp.asarray(s[k]) for k in ("poses", "K", "K_inv")}
    c = np.asarray(jcam.plane_sweep_coords(jnp.asarray(s["depths"]),
                                           f["poses"].reshape(B * S, 3, 4),
                                           jnp.repeat(f["K"], S, 0), jnp.repeat(f["K_inv"], S, 0),
                                           H, W)).reshape(B, S, -1, H, W, 2)
    x, y = c[..., 0], c[..., 1]
    return ((np.abs(x) < 1e-3) | (np.abs(x - (W - 1)) < 1e-3)
            | (np.abs(y) < 1e-3) | (np.abs(y - (H - 1)) < 1e-3))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_jax_float64(case):
    """Forward and both gradients against `jax.vjp` of the JAX composition, 1e-12."""
    s = _scene(case, np.float64)
    jout, (jref, jtgt) = _jax_corr(s)
    out, dref, dtgt = _port(s)
    assert out.shape == jout.shape and out.dtype == torch.float64
    assert out.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dref.numpy(), jref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dtgt.numpy(), jtgt, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_jax_float32(case):
    s = _scene(case, np.float32)
    jout, (jref, jtgt) = _jax_corr(s)
    out, dref, dtgt = _port(s)
    near = _near_edge(s)
    assert near.mean() < 1e-2, f"{near.sum()} of {near.size} samples near the edge"
    keep = ~near
    np.testing.assert_allclose(out.numpy()[keep], jout[keep], rtol=0,
                               atol=1e-5 * np.abs(jout).max())
    if not near.any():   # an edge flip moves whole taps of the gradients
        for got, want in ((dref, jref), (dtgt, jtgt)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_backward_plain_matches_autograd():
    """The plain backward against torch autograd through the plain forward,
    float64: the VJP it claims to be."""
    s = _scene(CASES[0], np.float64)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    M, Kt = _matrices(t)
    ref, tgt = t["ref"].requires_grad_(), t["tgt"].requires_grad_()
    H, W = ref.shape[1:3]
    x, y = tcam.sweep_pixel_coords(t["depths"], M.reshape(-1, 3, 3), Kt.reshape(-1, 3), H, W)
    S = M.shape[1]
    warped = tcam.bilinear_sample_plain(tgt.repeat_interleave(S, 0), torch.stack([x, y], -1))
    corr = (ref[:, None, None] * warped.reshape(ref.shape[0], S, *warped.shape[1:])).mean(-1)
    want = torch.autograd.grad(corr, (ref, tgt), t["g"])
    got = tcam.sweep_correlation_backward_plain(t["g"], t["ref"].detach(), t["tgt"].detach(),
                                                t["depths"], M, Kt)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_sums_in_the_kernels_order(dtype):
    """K1's arithmetic replayed in numpy float32 scalars: per sample, the
    products ref_c warped_c summed for c = 0..C-1 in order (a product and a
    sum rounded apart), one divide by C. The plain version gives those bits."""
    s = _scene(CASES[0], np.float32)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    ref, tgt = t["ref"].to(dtype), t["tgt"].to(dtype)
    M, Kt = _matrices(t)
    out = tcam.sweep_correlation_plain(ref, tgt, t["depths"], M, Kt).numpy()
    B, S, D, H, W = out.shape
    C = ref.shape[-1]
    x, y = tcam.sweep_pixel_coords(t["depths"], M.reshape(-1, 3, 3), Kt.reshape(-1, 3), H, W)
    warped = tcam.bilinear_sample_plain(tgt.float().repeat_interleave(S, 0),
                                        torch.stack([x, y], -1)).numpy().reshape(B, S, D, H, W, C)
    r = ref.float().numpy()
    f32 = np.float32
    rng = np.random.RandomState(3)
    for _ in range(200):
        b, si, d, yy, xx = (rng.randint(n) for n in (B, S, D, H, W))
        acc = f32(0)
        for c in range(C):
            acc = f32(acc + f32(r[b, yy, xx, c]) * f32(warped[b, si, d, yy, xx, c]))
        assert f32(acc / f32(C)) == out[b, si, d, yy, xx]


def test_pose_chunks_do_not_change_the_result(monkeypatch):
    """Poses go a chunk at a time: one pose a chunk gives the same bits
    (forward) and the same gradients to rounding (backward)."""
    s = _scene(CASES[0], np.float32)
    whole = _port(s)
    monkeypatch.setattr(tcam, "_PLAIN_CHUNK_ELEMENTS", 1)
    chunked = _port(s)
    assert torch.equal(whole[0], chunked[0])
    for a, b in zip(whole[1:], chunked[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5 * float(b.abs().max()))


def test_cpu_dispatch_and_gradient_route():
    """On CPU tensors `sweep_correlation` is the plain version, and autograd
    reaches the plain backward through `SweepCorrelationFn`."""
    s = _scene(CASES[1], np.float32)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    M, Kt = _matrices(t)
    ref, tgt = t["ref"].clone().requires_grad_(), t["tgt"].clone().requires_grad_()
    out = tcam.sweep_correlation(ref, tgt, t["depths"], t["poses"], t["K"], t["K_inv"])
    assert out.grad_fn is not None and "SweepCorrelationFn" in type(out.grad_fn).__name__
    assert torch.equal(out.detach(), tcam.sweep_correlation_plain(t["ref"], t["tgt"], t["depths"],
                                                                  M, Kt))
    out.backward(t["g"])
    dref, dtgt = tcam.sweep_correlation_backward_plain(t["g"], t["ref"], t["tgt"], t["depths"], M,
                                                       Kt)
    assert torch.equal(ref.grad, dref) and torch.equal(tgt.grad, dtgt)


def test_pose_gradient_is_refused():
    """A pose that requires grad (REGNet under POSENET in training) raises,
    naming the ROADMAP item of K2's pose gradient; no plain fallback."""
    s = _scene(CASES[0], np.float32)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    with pytest.raises(NotImplementedError, match="A.8d"):
        tcam.sweep_correlation(t["ref"].requires_grad_(), t["tgt"], t["depths"],
                               t["poses"].requires_grad_(), t["K"], t["K_inv"])


def test_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only, and say so before any build."""
    s = _scene(CASES[0], np.float32)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    M, Kt = _matrices(t)
    M, Kt = M.reshape(-1, 3, 3), Kt.reshape(-1, 3)
    with pytest.raises(ValueError, match="CUDA"):
        sweep_corr.sweep_correlation_cuda(t["ref"], t["tgt"], t["depths"], M, Kt)
    g = t["g"].contiguous(memory_format=torch.channels_last_3d)
    with pytest.raises(ValueError, match="CUDA"):
        sweep_corr.sweep_correlation_backward_cuda(g, t["ref"], t["tgt"], t["depths"], M, Kt)


@pytest.mark.parametrize("n", [3, 5])
def test_pose_grid_matches_jax(n):
    a = np.random.RandomState(n).uniform(-0.1, 0.1, 3)
    U, _, Vt = np.linalg.svd(np.array([[1, -a[2], a[1]], [a[2], 1, -a[0]], [-a[1], a[0], 1]]))
    pose = np.concatenate([U @ Vt, [[0.1], [-0.2], [0.9]]], 1)[None].astype(np.float32)
    want = np.asarray(jda.sample_pose_grid(jnp.asarray(pose), n, 0.12, 0.27))
    got = tda.sample_pose_grid(torch.from_numpy(pose), n, 0.12, 0.27).numpy()
    assert got.shape == (1, n ** 3, 3, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
