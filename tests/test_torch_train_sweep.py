"""The gradient of PSNet's cost volume in the port against the JAX package.

The port's sweep backward (`ops/camera.py::plane_sweep_volume_backward_plain`,
the plain version of the CUDA kernel `dsfm_plane_sweep_volume_backward`) is
held against `jax.vjp` of the cost volume as the JAX package builds it in
training (`ops/camera.py::plane_sweep_warp` and the [ref | warped] concat,
`models/psnet.py:253-260`), and against torch autograd through the port's
plain forward. Float32, small shapes, inputs made with numpy from a seed.
Tolerance: 1e-5 relative, with an absolute floor of 1e-5 of the largest
magnitude (the two sides sum the D planes and the taps in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.ops import camera as jcam
from deep_sfm_revisited_tpu_torch.ops import camera as tcam
from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp

torch.set_num_threads(1)
F32 = np.float32

# (B, D, H, W, C) and the pose: forward motion; t_z < 0 puts the near planes
# behind the camera; a sideways t pushes most samples out of the frame
CASES = [((1, 8, 12, 20, 32), "forward"), ((2, 5, 9, 13, 8), "forward"),
         ((1, 6, 10, 16, 8), "behind"), ((1, 6, 10, 16, 8), "outward")]
T = {"forward": (0.2, 0.05, 0.3), "behind": (0.1, -0.1, -3.0), "outward": (6.0, 0.2, 0.1)}


def _scene(shape, kind, seed=0):
    B, D, H, W, C = shape
    rng = np.random.RandomState(seed)
    K = np.broadcast_to(np.array([[0.9 * W, 0, W / 2 - 0.3], [0, 0.9 * W, H / 2 + 0.2],
                                  [0, 0, 1]]), (B, 3, 3)).astype(F32)
    a = rng.uniform(-0.05, 0.05, 3)
    R = np.array([[1, -a[2], a[1]], [a[2], 1, -a[0]], [-a[1], a[0], 1]])
    U, _, Vt = np.linalg.svd(R)
    pose = np.broadcast_to(np.concatenate([U @ Vt, np.reshape(T[kind], (3, 1))], 1),
                           (B, 3, 4)).astype(F32)
    return dict(ref=rng.randn(B, H, W, C).astype(F32), tgt=rng.randn(B, H, W, C).astype(F32),
                dvol=rng.randn(B, D, H, W, 2 * C).astype(F32),
                depths=(D / np.arange(1, D + 1)).astype(F32), pose=pose, K=K,
                K_inv=np.linalg.inv(K).astype(F32))


def _jax_vjp(s):
    j = {k: jnp.asarray(v) for k, v in s.items()}

    def volume(ref, tgt):
        warped = jcam.plane_sweep_warp(tgt, j["depths"], j["pose"], j["K"], j["K_inv"])
        return jnp.concatenate([jnp.broadcast_to(ref[:, None], warped.shape), warped], -1)

    _, vjp = jax.vjp(volume, j["ref"], j["tgt"])
    return [np.asarray(g) for g in vjp(j["dvol"])]


def _torch(s):
    return {k: torch.from_numpy(v) for k, v in s.items()}


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape,kind", CASES)
def test_backward_plain_matches_jax_vjp(shape, kind):
    s = _scene(shape, kind)
    t = _torch(s)
    M, Kt = tcam.sweep_matrices(t["pose"], t["K"], t["K_inv"])
    dref, dtgt = tcam.plane_sweep_volume_backward_plain(t["dvol"], t["depths"], M, Kt)
    jref, jtgt = _jax_vjp(s)
    assert dref.shape == dtgt.shape == shape[:1] + shape[2:]
    _close(dref, jref)
    _close(dtgt, jtgt)
    if kind != "forward":   # most samples are invalid there: some taps get nothing
        assert (jtgt == 0).any() and ((dtgt.numpy() == 0) == (jtgt == 0)).all()


@pytest.mark.parametrize("shape,kind", CASES)
def test_backward_plain_matches_autograd(shape, kind):
    """The explicit VJP equals torch autograd through the plain forward, and
    `plane_sweep_volume` with features that need a gradient goes through
    `PlaneSweepVolumeFn`, whose backward on CPU tensors is the plain VJP."""
    t = _torch(_scene(shape, kind, seed=1))
    M, Kt = tcam.sweep_matrices(t["pose"], t["K"], t["K_inv"])
    ref, tgt = t["ref"].requires_grad_(), t["tgt"].requires_grad_()
    vol = tcam.plane_sweep_volume_plain(ref, tgt, t["depths"], M, Kt)
    auto = torch.autograd.grad(vol, (ref, tgt), t["dvol"])
    plain = tcam.plane_sweep_volume_backward_plain(t["dvol"], t["depths"], M, Kt)
    vol_fn = tcam.plane_sweep_volume(ref, tgt, t["depths"], t["pose"], t["K"], t["K_inv"])
    assert vol_fn.grad_fn.name().startswith("PlaneSweepVolumeFn")
    assert torch.equal(vol_fn.detach(), vol.detach())
    via_fn = torch.autograd.grad(vol_fn, (ref, tgt), t["dvol"])
    for a, p, f in zip(auto, plain, via_fn):
        _close(p, a.numpy())
        assert torch.equal(p, f)


def test_only_the_needed_gradient_is_returned():
    t = _torch(_scene((1, 4, 6, 8, 8), "forward"))
    tgt = t["tgt"].requires_grad_()
    vol = tcam.plane_sweep_volume(t["ref"], tgt, t["depths"], t["pose"], t["K"], t["K_inv"])
    (g,) = torch.autograd.grad(vol, (tgt,), t["dvol"])
    assert g.shape == tgt.shape and t["ref"].grad is None


@pytest.mark.parametrize("which", ["pose", "K"])
def test_sweep_function_raises_on_a_pose_gradient(which):
    """M = K R K^-1 and K t have a gradient since slice 7 (PoseNet's pose is
    not stop-gradient): a pose or K that requires grad gets the plain pose
    gradient chained through `sweep_matrices`, never a silent zero; only the
    plane depths still make the autograd function raise."""
    t = _torch(_scene((1, 4, 6, 8, 8), "forward"))
    t[which].requires_grad_()
    vol = tcam.plane_sweep_volume(t["ref"].requires_grad_(), t["tgt"], t["depths"], t["pose"],
                                  t["K"], t["K_inv"])
    (got,) = torch.autograd.grad(vol, (t[which],), t["dvol"])
    M, Kt = tcam.sweep_matrices(t["pose"], t["K"], t["K_inv"])
    dM, dKt = tcam.plane_sweep_volume_pose_grad_plain(t["dvol"], t["tgt"], t["depths"],
                                                      M.detach(), Kt.detach())
    (want,) = torch.autograd.grad((M, Kt), (t[which],), (dM, dKt))
    assert float(got.abs().max()) > 0
    torch.testing.assert_close(got, want)
    with pytest.raises(NotImplementedError, match="plane depths"):
        tcam.PlaneSweepVolumeFn.apply(t["ref"], t["tgt"], t["depths"].requires_grad_(),
                                      M.detach(), Kt.detach())


def test_no_gradient_no_function():
    """Without a tracked input the volume is built directly (eval path)."""
    t = _torch(_scene((1, 4, 6, 8, 8), "forward"))
    vol = tcam.plane_sweep_volume(t["ref"], t["tgt"], t["depths"], t["pose"], t["K"],
                                  t["K_inv"])
    assert vol.grad_fn is None


def test_backward_wrapper_takes_cuda_tensors_only():
    """On the CPU the autograd function takes the plain VJP; the kernel's
    wrapper itself refuses CPU tensors and counts no launch."""
    t = _torch(_scene((1, 4, 6, 8, 8), "forward"))
    M, Kt = tcam.sweep_matrices(t["pose"], t["K"], t["K_inv"])
    before = sweep_warp.VOLUME_BACKWARD.launches
    with pytest.raises(ValueError, match="CUDA"):
        sweep_warp.plane_sweep_volume_backward_cuda(t["dvol"], t["depths"], M, Kt)
    assert sweep_warp.VOLUME_BACKWARD.launches == before
