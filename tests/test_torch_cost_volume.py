"""PSNet's plane-sweep cost volume in the port against the JAX package.

The port builds the whole (B, D, H, W, 2C) [ref | warped] volume in one call
(`ops/camera.py::plane_sweep_volume`: the sweep kernel on the card, its plain
version `plane_sweep_volume_plain` on the CPU). The JAX package builds it as
`concatenate([broadcast ref, plane_sweep_warp(...)], -1)`
(`deep_sfm_revisited_tpu/models/psnet.py:253-260`). Inputs are made with
numpy from a seed and fed to both sides, in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu.ops import camera as jcam
from deep_sfm_revisited_tpu_torch.config import SfMConfig
from deep_sfm_revisited_tpu_torch.models import psnet as tpsnet
from deep_sfm_revisited_tpu_torch.ops import camera as tcam
from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp

torch.set_num_threads(1)
F32 = np.float32

# (B, D, H, W, C): PSNet's C = 32 and a narrow C = 8, batch 1 and 2
SHAPES = [(1, 4, 12, 20, 8), (2, 6, 16, 24, 32), (1, 8, 24, 40, 32)]
# forward: a small forward motion; behind: t_z = -3 puts the near planes
# (d < ~3, the last ones: depths run far to near) behind the camera;
# outward: t_x = 6 pushes most samples out of the frame
POSES = {"forward": (0.2, 0.05, 0.3), "behind": (0.1, -0.1, -3.0), "outward": (6.0, 0.2, 0.1)}


def _rotation(rng):
    """A small random rotation (Rodrigues), float64."""
    a = rng.uniform(-0.08, 0.08, 3)
    th = np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _scene(shape, pose_kind, seed=0):
    B, D, H, W, C = shape
    rng = np.random.RandomState(seed)
    K = np.array([[0.9 * W, 0, W / 2 - 0.3], [0, 0.9 * W, H / 2 + 0.2], [0, 0, 1]])
    K = np.broadcast_to(K, (B, 3, 3)).astype(F32)
    pose = np.stack([np.concatenate([_rotation(rng), np.reshape(POSES[pose_kind], (3, 1))
                                     + rng.uniform(-0.05, 0.05, (3, 1))], axis=1)
                     for _ in range(B)]).astype(F32)
    labels = np.arange(1, D + 1, dtype=F32)
    return dict(ref=rng.randn(B, H, W, C).astype(F32), tgt=rng.randn(B, H, W, C).astype(F32),
                depths=(0.5 * 2 * D / labels).astype(F32),   # PSNet's min_depth nlabel / label
                pose=pose, K=K, K_inv=np.linalg.inv(K).astype(F32))


def _jax_volume(s):
    j = {k: jnp.asarray(v) for k, v in s.items()}
    warped = jcam.plane_sweep_warp(j["tgt"], j["depths"], j["pose"], j["K"], j["K_inv"])
    refb = jnp.broadcast_to(j["ref"][:, None], warped.shape)
    return np.asarray(jnp.concatenate([refb, warped], axis=-1))


def _near_edge(s):
    """(B, D, H, W) True where JAX's sampling coordinate lies within 1e-3 px of
    the frame's edge, where the in/out decision may flip on the last ulp."""
    H, W = s["ref"].shape[1:3]
    c = np.asarray(jcam.plane_sweep_coords(*(jnp.asarray(s[k]) for k in
                                             ("depths", "pose", "K", "K_inv")), H, W))
    x, y = c[..., 0], c[..., 1]
    return ((np.abs(x) < 1e-3) | (np.abs(x - (W - 1)) < 1e-3)
            | (np.abs(y) < 1e-3) | (np.abs(y - (H - 1)) < 1e-3))


def _port_plain(s):
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    M, Kt = tcam.sweep_matrices(t["pose"], t["K"], t["K_inv"])
    return tcam.plane_sweep_volume_plain(t["ref"], t["tgt"], t["depths"], M, Kt).numpy()


def _assert_volumes_match(got, ref, s):
    """float32, |port - JAX| <= 1e-4 max|feat| where JAX's coordinate is more
    than 1e-3 px from the frame's edge; those excluded stay under 0.1%."""
    assert got.shape == ref.shape
    near = _near_edge(s)
    assert near.mean() < 1e-3, f"{near.sum()} of {near.size} samples near the edge"
    keep = ~near
    scale = max(np.abs(s["ref"]).max(), np.abs(s["tgt"]).max())
    np.testing.assert_allclose(got[keep], ref[keep], atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("pose_kind", sorted(POSES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plane_sweep_volume_plain_matches_jax(shape, pose_kind):
    s = _scene(shape, pose_kind)
    ref, got = _jax_volume(s), _port_plain(s)
    _assert_volumes_match(got, ref, s)
    warped = got[..., shape[-1]:]
    if pose_kind == "behind":   # the planes behind the camera give exact zeros
        assert (warped[:, -2:] == 0).all() and (warped[:, 0] != 0).any()
    if pose_kind == "outward":
        assert (warped == 0).mean() > 0.5


def test_plane_sweep_volume_plain_matches_pallas_interpret():
    """Against the Pallas kernel in interpret mode, at one tiny shape."""
    from deep_sfm_revisited_tpu.ops.pallas.sweep_warp import plane_sweep_warp_pallas

    s = _scene((1, 3, 8, 12, 8), "forward", seed=1)
    j = {k: jnp.asarray(v) for k, v in s.items()}
    warped = plane_sweep_warp_pallas(j["tgt"], j["depths"], j["pose"], j["K"], j["K_inv"],
                                     interpret=True)
    ref = np.concatenate([np.broadcast_to(s["ref"][:, None], warped.shape),
                          np.asarray(warped)], axis=-1)
    _assert_volumes_match(_port_plain(s), ref, s)


@pytest.mark.parametrize("pose_kind", sorted(POSES))
def test_sweep_coordinates_match_jax(pose_kind):
    """The port's one coordinate formula (`sweep_pixel_coords`, through
    `plane_sweep_coords`) against JAX's `plane_sweep_coords`: 1e-4 px, 1e-5
    relative (float32; the sides sum the 3x3 products in different orders),
    behind-camera planes taking the (2W, 2H) sentinel on both."""
    s = _scene((2, 6, 12, 20, 8), pose_kind, seed=2)
    H, W = s["ref"].shape[1:3]
    args = [s[k] for k in ("depths", "pose", "K", "K_inv")]
    ref = np.asarray(jcam.plane_sweep_coords(*map(jnp.asarray, args), H, W))
    got = tcam.plane_sweep_coords(*map(torch.from_numpy, args), H, W).numpy()
    assert got.shape == ref.shape == (2, 6, H, W, 2)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    if pose_kind == "behind":
        np.testing.assert_array_equal(got[:, -2:], np.broadcast_to([2.0 * W, 2.0 * H],
                                                                   got[:, -2:].shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plane_sweep_volume_on_cpu_is_the_plain_version(dtype):
    """On CPU tensors `plane_sweep_volume` is the plain version, bit for bit,
    in the features' dtype; its NCDHW view has channels-last-3d strides and
    its ref half is the ref features on every plane."""
    s = _scene((2, 5, 12, 20, 8), "forward", seed=3)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    ref, tgt = t["ref"].to(dtype), t["tgt"].to(dtype)
    got = tcam.plane_sweep_volume(ref, tgt, t["depths"], t["pose"], t["K"], t["K_inv"])
    M, Kt = tcam.sweep_matrices(t["pose"], t["K"], t["K_inv"])
    assert got.dtype == dtype and tuple(got.shape) == (2, 5, 12, 20, 16)
    assert torch.equal(got, tcam.plane_sweep_volume_plain(ref, tgt, t["depths"], M, Kt))
    assert torch.equal(got[..., :8], ref[:, None].expand(2, 5, 12, 20, 8))
    assert got.permute(0, 4, 1, 2, 3).is_contiguous(memory_format=torch.channels_last_3d)


def test_sweep_wrapper_refuses_cpu_tensors():
    """The sweep kernel's wrapper never computes on the CPU:
    `plane_sweep_volume` picks the plain version for CPU tensors, the
    wrapper itself raises."""
    f = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        sweep_warp.plane_sweep_volume_cuda(f, f, torch.ones(3), torch.eye(3)[None],
                                           torch.zeros(1, 3))


def test_psnet_builds_one_volume_per_target(monkeypatch):
    """PSNet makes one `plane_sweep_volume` call per target and hands its
    channels-last-3d (B, 2C, D, h4, w4) view to the hourglass unchanged."""
    cfg = SfMConfig.kitti(8).depth
    net = tpsnet.PSNet(cfg).eval()
    calls, seen = [], []
    real_volume, real_hourglass = tpsnet.plane_sweep_volume, net._hourglass

    def volume(*args):
        calls.append(args[0].shape)
        return real_volume(*args)

    def hourglass(cost):
        seen.append((tuple(cost.shape), cost.is_contiguous(memory_format=torch.channels_last_3d)))
        return real_hourglass(cost)

    monkeypatch.setattr(tpsnet, "plane_sweep_volume", volume)
    monkeypatch.setattr(net, "_hourglass", hourglass)
    rng = np.random.RandomState(4)
    ref = torch.from_numpy(rng.uniform(-1, 1, (1, 32, 64, 3)).astype(F32))
    tgts = torch.from_numpy(rng.uniform(-1, 1, (1, 2, 32, 64, 3)).astype(F32))
    pose = torch.eye(3, 4).expand(1, 2, 3, 4).clone()
    pose[..., 0, 3] = 0.2
    K = torch.tensor([[[40.0, 0, 32], [0, 40.0, 16], [0, 0, 1]]])
    with torch.no_grad():
        depth_init, depth = net(ref, tgts, pose, K)
    assert len(calls) == 2 and seen == [((1, 64, 8, 8, 16), True)] * 2
    assert tuple(depth.shape) == (1, 32, 64) and torch.isfinite(depth).all()
