"""The port's camera ops, rotations, config and kernel B1 against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. JAX runs in
float32 explicitly (conftest enables x64 globally).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu import config as jconfig
from deep_sfm_revisited_tpu.ops import camera as jcam
from deep_sfm_revisited_tpu.ops import rotations as jrot
from deep_sfm_revisited_tpu_torch import config as tconfig
from deep_sfm_revisited_tpu_torch.ops import camera as tcam
from deep_sfm_revisited_tpu_torch.ops import rotations as trot
from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp

torch.set_num_threads(1)
F32 = np.float32


def _scene(seed=0, b=2, h=12, w=20):
    rng = np.random.RandomState(seed)
    K = np.array([[18.0, 0, w / 2], [0, 17.0, h / 2], [0, 0, 1]], F32)
    K = np.broadcast_to(K, (b, 3, 3)).copy()
    R = np.asarray(jrot.angle_to_matrix(jnp.asarray(
        rng.uniform(-0.1, 0.1, (b, 3)), jnp.float32)))
    t = rng.uniform(-0.5, 0.5, (b, 3, 1)).astype(F32)
    t[0, 2] = -0.45  # with the tiny depths below: points behind the camera
    pose = np.concatenate([R, t], axis=-1).astype(F32)
    depth = rng.uniform(1.0, 6.0, (b, h, w)).astype(F32)
    # a few pixels right at the camera plane: behind-camera projections
    depth[:, 0, :3] = 1e-4
    feat = rng.randn(b, h, w, 5).astype(F32)
    return dict(K=K, K_inv=np.linalg.inv(K).astype(F32), pose=pose,
                depth=depth, feat=feat, depths=np.array([1.5, 3.0, 9.0], F32))


def _coords(seed, b, h, w, kind):
    rng = np.random.RandomState(seed)
    c = rng.uniform(-3.0, 1.0, (b, 5, 7, 9, 2)).astype(F32)
    c = c * np.array([w + 4, h + 4], F32)  # spans in- and out-of-range
    if kind == "edges":
        # exact borders, the last row/column and behind-camera sentinels
        c[:, 0, 0, :4] = [[0, 0], [w - 1, h - 1], [w - 1, 0.5], [2 * w, 2 * h]]
        c[:, 1] = np.round(c[:, 1])
    return c


# bilinear_sample: f32 to 1e-6 (the two sides may round the 4-tap blend
# differently by an ulp); bf16 exactly, since both blend in f32 and round
# once to bf16 (the JAX interpret-mode pin, tests/test_camera.py:122-127)
@pytest.mark.parametrize("kind", ["random", "edges"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_sample_matches_jax(dtype, kind):
    b, h, w, c = 2, 12, 20, 32
    img = np.random.RandomState(3).randn(b, h, w, c).astype(F32)
    coords = _coords(4, b, h, w, kind)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jcam.bilinear_sample(jnp.asarray(img).astype(jd), jnp.asarray(coords))
    got = tcam.bilinear_sample(torch.from_numpy(img).to(td), torch.from_numpy(coords))
    assert got.dtype == td and tuple(got.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got, ref)


def _run_camera_op(name, mod, s, to):
    if name == "pixel2cam":
        return mod.pixel2cam(to(s["depth"]), to(s["K_inv"]))
    if name == "cam2pixel":
        cam = mod.pixel2cam(to(s["depth"]), to(s["K_inv"]))
        proj = to(np.einsum("bij,bjk->bik", s["K"], s["pose"]))
        return mod.cam2pixel(cam, proj[:, :, :3], proj[:, :, 3:])
    if name == "inverse_warp":
        return mod.inverse_warp(to(s["feat"]), to(s["depth"]), to(s["pose"]),
                                to(s["K"]), to(s["K_inv"]))
    if name == "pose2flow":
        return mod.pose2flow(to(s["depth"]), to(s["pose"]), to(s["K"]),
                             to(s["K_inv"]))
    h, w = s["depth"].shape[1:]
    if name == "plane_sweep_coords":
        return mod.plane_sweep_coords(to(s["depths"]), to(s["pose"]), to(s["K"]),
                                      to(s["K_inv"]), h, w)
    if name == "plane_sweep_warp":
        return mod.plane_sweep_warp(to(s["feat"]), to(s["depths"]), to(s["pose"]),
                                    to(s["K"]), to(s["K_inv"]))
    raise KeyError(name)


# camera ops: 1e-4 px (float32 projections; the two sides contract the
# 3x3 products in different orders)
@pytest.mark.parametrize("name", ["pixel2cam", "cam2pixel", "inverse_warp",
                                  "pose2flow", "plane_sweep_coords",
                                  "plane_sweep_warp"])
def test_camera_op_matches_jax(name):
    s = _scene()
    ref = np.asarray(_run_camera_op(name, jcam, s, jnp.asarray))
    got = _run_camera_op(name, tcam, s, torch.from_numpy).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    if name == "cam2pixel":  # the behind-camera pixels took the sentinel
        np.testing.assert_array_equal(got[0, 0, :3], [[40.0, 24.0]] * 3)


# rotations: float64 to 1e-12 (closed forms, same formula on both sides)
@pytest.mark.parametrize("name", ["skew", "exp_so3", "exp_so3_small",
                                  "angle_to_matrix", "rotation_angular_error"])
def test_rotation_matches_jax(name):
    rng = np.random.RandomState(7)
    v = rng.uniform(-1.0, 1.0, (6, 3))
    if name == "exp_so3_small":
        v = v * 1e-7
    a, b = jnp.asarray(v), torch.from_numpy(v)
    if name == "skew":
        ref, got = jrot.skew(a), trot.skew(b)
    elif name.startswith("exp_so3"):
        ref, got = jrot.exp_so3(a), trot.exp_so3(b)
    elif name == "angle_to_matrix":
        ref, got = jrot.angle_to_matrix(a), trot.angle_to_matrix(b)
    else:
        R1, R2 = jrot.angle_to_matrix(a), jrot.angle_to_matrix(a[::-1])
        ref = jrot.rotation_angular_error(R1, R2)
        got = trot.rotation_angular_error(torch.tensor(np.asarray(R1)),
                                          torch.tensor(np.asarray(R2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12, rtol=0)


@pytest.mark.parametrize("nlabel", [64, 128])
def test_config_copy_matches_jax(nlabel, tmp_path):
    """The port's config.py is a field-for-field copy of the JAX one."""
    assert tconfig.SfMConfig.kitti(nlabel).to_dict() == \
        jconfig.SfMConfig.kitti(nlabel).to_dict()
    for jc, tc in ((jconfig.SfMConfig, tconfig.SfMConfig),
                   (jconfig.PoseConfig, tconfig.PoseConfig),
                   (jconfig.DepthConfig, tconfig.DepthConfig),
                   (jconfig.FlowConfig, tconfig.FlowConfig)):
        assert [f.name for f in dataclasses.fields(jc)] == \
            [f.name for f in dataclasses.fields(tc)]
    over = {"pose.num_hypotheses": 16, "depth.nlabel": 8}
    assert tconfig.SfMConfig.kitti().override(**over).to_dict() == \
        jconfig.SfMConfig.kitti().override(**over).to_dict()
    path = tmp_path / "cfg.yml"
    path.write_text("pose:\n  ransac_iter: 2\nflow:\n  estimator: DICL\n")
    assert tconfig.config_from_yaml(str(path)).to_dict() == \
        jconfig.config_from_yaml(str(path)).to_dict()
    with pytest.raises(KeyError):
        tconfig.SfMConfig().override(**{"pose.nope": 1})


def test_b1_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: camera.bilinear_sample
    picks the plain version for CPU tensors, the wrapper itself raises."""
    img = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        sweep_warp.bilinear_sample_cuda(img, torch.zeros(1, 3, 2))
