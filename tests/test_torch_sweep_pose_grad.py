"""The plane sweep's gradient with respect to the pose, in the port against the JAX package.

The port's pose gradient of PSNet's cost volume (`ops/camera.py::
plane_sweep_volume_pose_grad_plain`, the plain version of the CUDA kernel
`dsfm_plane_sweep_volume_pose_grad`) is held, in float64, against
`jax.vjp` of the JAX package's volume (`ops/camera.py::plane_sweep_warp` and
the [ref | warped] concat, `models/psnet.py:253-260`): with respect to
M = K R K^-1 and K t, and with respect to the pose through
`sweep_matrices` and `PlaneSweepVolumeFn`. And against torch autograd
through the port's plain forward, away from the frame's edges (there torch's
clamp passes the gradient whole where JAX's clip halves it, and the port's
forward reads a clamped +1 tap where JAX reads its zero pad; the plain
gradient follows JAX).

Tolerance: 1e-6 relative with an absolute floor of 1e-6 of the largest
magnitude. Both sides compute the bilinear weights from float32 coordinates
(the gather casts them, in JAX as in the port) and sum in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.ops import camera as jcam
from deep_sfm_revisited_tpu_torch.ops import camera as tcam

torch.set_num_threads(1)
F64 = np.float64

# pose kinds: a small random motion; the identity with K and K^-1 exact in
# binary, so every sample lies on integer coordinates and the frame's first
# and last rows and columns are hit exactly; t_z < 0, so the near planes lie
# behind the camera; a sideways t, so most samples leave the frame
KINDS = ["random", "edge", "behind", "outward"]
T = {"random": (0.2, 0.05, 0.3), "edge": (0.0, 0.0, 0.0), "behind": (0.1, -0.1, -3.0),
     "outward": (2.0, 0.2, 0.1)}
SHAPES = [(1, 6, 10, 16, 8), (2, 5, 9, 13, 4)]


def _scene(shape, kind, seed=0):
    B, D, H, W, C = shape
    rng = np.random.RandomState(seed)
    if kind == "edge":
        K = np.array([[4.0, 0, 8.0], [0, 4.0, 4.0], [0, 0, 1]])
        K_inv = np.array([[0.25, 0, -2.0], [0, 0.25, -1.0], [0, 0, 1]])
        R = np.eye(3)
        depths = np.array([1.0, 2.0, 4.0, 0.5, 8.0, 0.25][:D])
    else:
        K = np.array([[0.9 * W, 0, W / 2 - 0.3], [0, 0.9 * W, H / 2 + 0.2], [0, 0, 1]])
        K_inv = np.linalg.inv(K)
        a = rng.uniform(-0.05, 0.05, 3)
        U, _, Vt = np.linalg.svd(np.array([[1, -a[2], a[1]], [a[2], 1, -a[0]],
                                           [-a[1], a[0], 1]]))
        R = U @ Vt
        depths = D / np.arange(1.0, D + 1)
    pose = np.concatenate([R, np.reshape(T[kind], (3, 1))], 1)
    return dict(ref=rng.randn(B, H, W, C), tgt=rng.randn(B, H, W, C),
                dvol=rng.randn(B, D, H, W, 2 * C), depths=depths.astype(F64),
                pose=np.broadcast_to(pose, (B, 3, 4)).copy(),
                K=np.broadcast_to(K, (B, 3, 3)).copy(), K_inv=np.broadcast_to(K_inv, (B, 3, 3)).copy())


def _jax_volume_of_matrices(s):
    """The JAX volume as a function of (M, K t): `plane_sweep_coords` with
    its K R K^-1 and K t given, then the package's `bilinear_sample`."""
    tgt, depths = jnp.asarray(s["tgt"]), jnp.asarray(s["depths"])
    ref = jnp.asarray(s["ref"])
    B, H, W, _ = tgt.shape

    def volume(M, Kt):
        grid = jcam.pixel_grid(H, W, depths.dtype).reshape(3, -1)
        ray = jnp.einsum("bij,jn->bin", M, grid)
        p = ray[:, None] * depths[None, :, None, None] + Kt[:, None, :, None]
        z = jnp.maximum(p[:, :, 2], 1e-3)
        invalid = p[:, :, 2] <= 1e-3
        x = jnp.where(invalid, 2.0 * W, p[:, :, 0] / z)
        y = jnp.where(invalid, 2.0 * H, p[:, :, 1] / z)
        coords = jnp.stack([x, y], axis=-1).reshape(B, depths.shape[0], H, W, 2)
        warped = jcam.bilinear_sample(tgt, coords)
        return jnp.concatenate([jnp.broadcast_to(ref[:, None], warped.shape), warped], -1)

    return volume


def _matrices(s):
    return tcam.sweep_matrices(*(torch.from_numpy(s[k]) for k in ("pose", "K", "K_inv")))


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_pose_grad_plain_matches_jax_vjp(shape, kind):
    """dM and dK t against `jax.vjp` of the JAX volume with respect to them."""
    s = _scene(shape, kind)
    M, Kt = _matrices(s)
    _, vjp = jax.vjp(_jax_volume_of_matrices(s), jnp.asarray(M.numpy()),
                     jnp.asarray(Kt.numpy()))
    jM, jKt = (np.asarray(g) for g in vjp(jnp.asarray(s["dvol"])))
    dM, dKt = tcam.plane_sweep_volume_pose_grad_plain(
        torch.from_numpy(s["dvol"]), torch.from_numpy(s["tgt"]),
        torch.from_numpy(s["depths"]), M, Kt)
    assert dM.shape == (shape[0], 3, 3) and dKt.shape == (shape[0], 3)
    assert dM.dtype == dKt.dtype == torch.float64
    assert np.abs(jM).max() > 0
    _close(dM, jM)
    _close(dKt, jKt)


@pytest.mark.parametrize("kind", KINDS)
def test_pose_grad_through_the_function_matches_jax(kind):
    """The gradient with respect to the pose: the port's `plane_sweep_volume`
    (sweep_matrices, then `PlaneSweepVolumeFn`) by torch autograd against
    `jax.vjp` of the package's `plane_sweep_warp` with the concat; the
    features' gradients with it."""
    s = _scene(SHAPES[1], kind)
    j = {k: jnp.asarray(v) for k, v in s.items()}

    def volume(ref, tgt, pose):
        warped = jcam.plane_sweep_warp(tgt, j["depths"], pose, j["K"], j["K_inv"])
        return jnp.concatenate([jnp.broadcast_to(ref[:, None], warped.shape), warped], -1)

    _, vjp = jax.vjp(volume, j["ref"], j["tgt"], j["pose"])
    jref, jtgt, jpose = (np.asarray(g) for g in vjp(j["dvol"]))
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    for k in ("ref", "tgt", "pose"):
        t[k].requires_grad_(True)
    vol = tcam.plane_sweep_volume(t["ref"], t["tgt"], t["depths"], t["pose"], t["K"], t["K_inv"])
    vol.backward(t["dvol"])
    _close(t["pose"].grad, jpose)
    _close(t["ref"].grad, jref)
    _close(t["tgt"].grad, jtgt)


@pytest.mark.parametrize("kind", ["random", "behind", "outward"])
def test_pose_grad_plain_matches_autograd(kind):
    """Away from the frame's edges the plain gradient is torch autograd's
    through `plane_sweep_volume_plain`."""
    s = _scene(SHAPES[0], kind, seed=3)
    M, Kt = (m.clone().requires_grad_(True) for m in _matrices(s))
    t = {k: torch.from_numpy(s[k]) for k in ("ref", "tgt", "depths", "dvol")}
    tcam.plane_sweep_volume_plain(t["ref"], t["tgt"], t["depths"], M, Kt).backward(t["dvol"])
    dM, dKt = tcam.plane_sweep_volume_pose_grad_plain(t["dvol"], t["tgt"], t["depths"],
                                                      M.detach(), Kt.detach())
    _close(dM, M.grad.numpy())
    _close(dKt, Kt.grad.numpy())


def test_no_valid_sample_gives_exact_zeros():
    """Every plane behind the camera: no sample, exactly zero."""
    s = _scene(SHAPES[0], "behind")
    M, Kt = _matrices(s)
    Kt = Kt.clone()
    Kt[:, 2] = -1e4
    dM, dKt = tcam.plane_sweep_volume_pose_grad_plain(
        torch.from_numpy(s["dvol"]), torch.from_numpy(s["tgt"]),
        torch.from_numpy(s["depths"]), M, Kt)
    assert (dM == 0).all() and (dKt == 0).all()


def test_pose_grad_runs_only_where_the_pose_needs_it(monkeypatch):
    """`PlaneSweepVolumeFn` computes the pose gradient only when M or K t
    requires grad, the features' only when ref or tgt does."""
    s = _scene(SHAPES[0], "random")
    calls = []
    for name in ("plane_sweep_volume_pose_grad_plain", "plane_sweep_volume_backward_plain"):
        fn = getattr(tcam, name)
        monkeypatch.setattr(tcam, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    t["tgt"].requires_grad_(True)
    tcam.plane_sweep_volume(t["ref"], t["tgt"], t["depths"], t["pose"], t["K"],
                            t["K_inv"]).backward(t["dvol"])
    assert calls == ["plane_sweep_volume_backward_plain"]
    calls.clear()
    pose = t["pose"].clone().requires_grad_(True)
    tcam.plane_sweep_volume(t["ref"], t["tgt"].detach(), t["depths"], pose, t["K"],
                            t["K_inv"]).backward(t["dvol"])
    assert calls == ["plane_sweep_volume_pose_grad_plain"] and pose.grad is not None


def test_depths_still_get_no_gradient():
    s = _scene(SHAPES[0], "random")
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    t["depths"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="plane depths"):
        tcam.plane_sweep_volume(t["ref"], t["tgt"], t["depths"], t["pose"], t["K"], t["K_inv"])
