"""PANet and REGNet in the port against the JAX modules, eval forward, float32.

The JAX variables (random, every BN statistic and bias off its init) go
through the port's weight bridge (`utils/weights.py::panet_entries`,
`regnet_entries`) into the torch modules. 32x64 images, nlabel 8, 3 pose
scales (PANet) and a 3^3 pose grid (REGNet). Also: the pose hypotheses
against JAX, and the refusals (PANet does not train; REGNet's pose gets no
gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables, t2n

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models import depth_alternates as jda
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models import depth_alternates as tda
from deep_sfm_revisited_tpu_torch.train import trainer
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)
B, H, W, NLABEL = 1, 32, 64, 8
# 3 pose scales for PANet (0.95, 1.0, 1.05), a 3^3 grid for REGNet
OVER = {"depth.scale_min": 0.95, "depth.scale_max": 1.06, "depth.scale_step": 0.05,
        "depth.regnet_sample_num": 3}
NETS = {"PANET": (jda.PANet, tda.PANet, weights.panet_entries),
        "REGNET": (jda.REGNet, tda.REGNet, weights.regnet_entries)}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    tgt = (np.roll(ref, 2, axis=2)[:, None]
           + 0.05 * rng.randn(B, 1, H, W, 3)).astype(np.float32)
    K = np.array([[[45.0, 0, W / 2], [0, 45.0, H / 2], [0, 0, 1]]], np.float32)
    a = 0.02
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    pose = np.concatenate([R, [[0.3], [0.05], [0.9]]], 1)[None, None].astype(np.float32)
    return ref, tgt, pose, K


@pytest.fixture(scope="module", params=sorted(NETS))
def net_pair(request):
    """(name, JAX outputs, torch outputs) of one eval forward with shared weights."""
    jcls, tcls, entries = NETS[request.param]
    ref, tgt, pose, K = _inputs()
    jnet = jcls(JConfig.kitti(NLABEL).override(**OVER).depth)
    args = [jnp.asarray(a) for a in (ref, tgt, pose, K, np.linalg.inv(K))]
    variables = random_variables(jnet.init, jax.random.PRNGKey(0), *args, seed=1)
    jout = jax.jit(jnet.apply)(variables, *args)
    tnet = tcls(TConfig.kitti(NLABEL).override(**OVER).depth).eval()
    load_strict(tnet, weights.convert(variables, entries("", "")))
    with torch.no_grad():
        tout = tnet(*(torch.from_numpy(a) for a in (ref, tgt, pose, K)))
    return (request.param, [None if o is None else np.asarray(o) for o in jout],
            [None if o is None else t2n(o) for o in tout])


# f32 through ~40 convolutions summed in another order on each side, and
# sampling coordinates one ulp apart: depth to 1e-4 relative (depths here are
# 1..8 m), as PSNet's
@pytest.mark.parametrize("which", ["depth_init", "depth"])
def test_depth_matches_jax(net_pair, which):
    name, jout, tout = net_pair
    i = 0 if which == "depth_init" else 1
    if name == "PANET" and which == "depth_init":   # PANet returns (None, depth), as JAX
        assert jout[0] is None and tout[0] is None
        return
    assert tout[i].shape == (B, H, W) and np.isfinite(tout[i]).all()
    np.testing.assert_allclose(tout[i], jout[i], rtol=1e-4, atol=1e-4)


def test_pose_scales_match_jax():
    cfg = TConfig.kitti().depth
    np.testing.assert_array_equal(tda.pose_scales(cfg), jda.pose_scales(JConfig.kitti().depth))
    assert len(tda.pose_scales(cfg)) == 9    # PANet's default: 0.9, 0.925, ..., 1.1
    _, _, pose, _ = _inputs()
    scales = tda.pose_scales(TConfig.kitti().override(**OVER).depth).astype(np.float32)
    for full in (False, True):
        want = np.asarray(jda.sample_pose_by_scale(jnp.asarray(pose[:, 0]), jnp.asarray(scales),
                                                   full_translation=full))
        got = tda.sample_pose_by_scale(torch.from_numpy(pose[:, 0]), torch.from_numpy(scales),
                                       full_translation=full).numpy()
        assert got.shape == (B, 3, 3, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_panet_builds_one_sweep_for_all_scales(monkeypatch):
    """PANet's volume is one `plane_sweep_volume` call a target, the scales
    folded into its batch (B S, one pose and K a batch item)."""
    calls = []
    real = tda.plane_sweep_volume

    def volume(ref, tgt, depths, pose, K, K_inv):
        calls.append((tuple(ref.shape), tuple(pose.shape), tuple(K.shape)))
        return real(ref, tgt, depths, pose, K, K_inv)

    monkeypatch.setattr(tda, "plane_sweep_volume", volume)
    net = tda.PANet(TConfig.kitti(NLABEL).override(**OVER).depth).eval()
    ref, tgt, pose, K = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        net(ref, tgt, pose, K)
    assert calls == [((3 * B, H // 4, W // 4, 32), (3 * B, 3, 4), (3 * B, 3, 3))]


def test_panet_training_is_refused():
    """PANet returns no depth_init, so the depth loss cannot take it: the
    JAX trainer fails on it, and the port refuses it before a step, naming
    that failure."""
    cfg = TConfig.kitti(NLABEL).override(**{"depth.estimator": "PANET"})
    with pytest.raises(NotImplementedError, match="train/trainer.py:216-217"):
        trainer.Trainer(torch.nn.Linear(1, 1), cfg, steps_per_epoch=1)
    trainer.refuse_depth_without_init(cfg.override(**{"depth.estimator": "REGNET"}))


def test_regnet_pose_gradient_is_refused():
    """REGNet in train mode with a pose that needs a gradient (the POSENET
    route) raises: K2 has no pose gradient yet (ROADMAP A.8d)."""
    net = tda.REGNet(TConfig.kitti(NLABEL).override(**OVER).depth)
    ref, tgt, pose, K = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(NotImplementedError, match="A.8d"):
        net(ref, tgt, pose.requires_grad_(), K)
