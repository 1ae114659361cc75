"""The port's SFMNet eval slice against the JAX composite, in float32.

One JAX `SFMNet` (the KITTI recipe cut to 128x128, nlabel 8, 16 x 1
hypotheses, 128 correspondences, two-stage scoring on) and the port with
the same weights (through the bridge) and the same random draws: the JAX
key is split exactly as `sfmnet.py:245-247`, `flow_ops.py:145-148,58,
173-175` and `essential.py:724` split it, and the draws are handed to the
port. Candidates are solved in float64 here (`pose.solve_dtype`), so the
vote is reproducible across the two frameworks. The float32 fast path
differs from JAX's by f32 rounding, which tests/test_torch_ransac.py
bounds on a well-posed scene; with random weights the flow is not a
well-posed scene, so the slice runs that path on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables, t2n

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models.sfmnet import SFMNet as JSFMNet
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet as TSFMNet
from deep_sfm_revisited_tpu_torch.utils.weights import jax_params_to_torch

torch.set_num_threads(1)
B, H, W = 1, 128, 128
OVER = {"depth.nlabel": 8, "pose.num_hypotheses": 16, "pose.ransac_iter": 1,
        "pose.num_correspondences": 128, "pose.score_subset": 32,
        "pose.score_topk": 64, "pose.polish_iters": 5}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    tgt = (np.roll(ref, (1, 3), axis=(1, 2)) + 0.05 * rng.randn(B, H, W, 3)).astype(np.float32)
    K = np.array([[[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]]], np.float32)
    a = 0.03
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    pose_gt = np.concatenate([R, [[0.2], [0.0], [0.95]]], 1)[None].astype(np.float32)
    return ref, tgt, K, pose_gt


def _draws(key, cfg, oversample=4):
    """The JAX composite's internal draws, reproduced for injection
    (`oversample` 1 for the uniform sampler's candidate grid)."""
    pc = cfg.pose
    n_cand = pc.num_correspondences * oversample
    k_sample, k_ransac = jax.random.split(key)
    k_grid, k_gumbel = jax.random.split(k_sample)
    return {
        "jitter": torch.from_numpy(np.array(jax.random.uniform(
            k_grid, (B, n_cand, 2), jnp.float32, -0.5, 0.5))),
        "gumbel_u": torch.from_numpy(np.array(jax.random.uniform(
            k_gumbel, (B, n_cand), jnp.float32, 1e-12, 1.0))),
        "sample_idx": torch.from_numpy(np.array(jax.random.randint(
            k_ransac, (B, pc.num_hypotheses * pc.ransac_iter, 5), 0,
            pc.num_correspondences))),
    }


@pytest.fixture(scope="module")
def slice_runs():
    """route -> (JAX outputs, port outputs), one model and weight set."""
    ref, tgt, K, pose_gt = _inputs()
    key = jax.random.PRNGKey(5)
    runs = {}
    variables = None
    for route in ("online-f64", "gt_pose", "online-f32"):
        over = dict(OVER, **{"pose.solve_dtype": "float32" if route == "online-f32"
                             else "float64"})
        jcfg, tcfg = JConfig.kitti().override(**over), TConfig.kitti().override(**over)
        jnet = JSFMNet(jcfg)
        args = [jnp.asarray(a) for a in (ref, tgt, K)]
        if variables is None:
            variables = random_variables(
                lambda r, t, k: jnet.init(jax.random.PRNGKey(1), r, t, k,
                                          key=jax.random.PRNGKey(2)), *args, seed=3)
        gt = route == "gt_pose"
        jout = {}
        if route != "online-f32":
            jout = jax.jit(lambda v, r, t, k, p, kk: jnet.apply(
                v, r, t, k, pose_gt=p, use_gt_pose=gt, key=kk))(
                variables, *args, jnp.asarray(pose_gt), key)
        tnet = TSFMNet(tcfg, device="cpu")
        load_strict(tnet, jax_params_to_torch(variables))
        tout = tnet(*(torch.from_numpy(a) for a in (ref, tgt, K)),
                    pose_gt=torch.from_numpy(pose_gt), use_gt_pose=gt,
                    draws=_draws(key, tcfg))
        runs[route] = ({k: np.asarray(v) for k, v in jout.items() if v is not None},
                       {k: t2n(v) for k, v in tout.items() if v is not None})
    return runs


def test_slice_returns_the_jax_keys(slice_runs):
    jout, tout = slice_runs["online-f64"]
    assert set(tout) == set(jout)
    assert tout["depth"].shape == (B, H, W) and tout["pose"].shape == (B, 3, 4)


# flow: 1e-3 px (f32 DICL, as tests/test_torch_dicl.py)
def test_slice_flow_matches_jax(slice_runs):
    jout, tout = slice_runs["online-f64"]
    np.testing.assert_allclose(tout["flow"], jout["flow"], rtol=0, atol=1e-3)


def test_slice_sampler_matches_jax(slice_runs):
    """Same confident-candidate count (the entropy sampler's fallback test)."""
    jout, tout = slice_runs["online-f64"]
    np.testing.assert_array_equal(tout["num_matches"], jout["num_matches"])


# pose: float64 candidates -> the same winner: inliers equal, P to 1e-5
# (flow enters at 1e-3 px, i.e. ~1e-5 in normalized coordinates)
def test_slice_pose_matches_jax(slice_runs):
    jout, tout = slice_runs["online-f64"]
    np.testing.assert_array_equal(tout["inliers"], jout["inliers"])
    np.testing.assert_allclose(tout["pose"], jout["pose"], rtol=0, atol=1e-5)


def test_slice_fast_path_pose_is_well_formed(slice_runs):
    """The shipped float32 candidate path on the same flow: a proper
    rotation and a unit translation, and a finite depth."""
    f64, f32 = slice_runs["online-f64"][1], slice_runs["online-f32"][1]
    np.testing.assert_array_equal(f32["flow"], f64["flow"])
    P = f32["pose"][0]
    np.testing.assert_allclose(P[:, :3] @ P[:, :3].T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(P[:, :3]), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(P[:, 3]), 1.0, atol=1e-6)
    assert np.isfinite(f32["depth"]).all() and f32["inliers"][0] > 0


# depth: with the pose equal, 1e-4 relative as tests/test_torch_psnet.py
@pytest.mark.parametrize("which", ["depth_init", "depth"])
@pytest.mark.parametrize("route", ["online-f64", "gt_pose"])
def test_slice_depth_matches_jax(slice_runs, route, which):
    jout, tout = slice_runs[route]
    assert np.isfinite(tout[which]).all()
    np.testing.assert_allclose(tout[which], jout[which], rtol=1e-4, atol=1e-4)


def test_pred_pose_route_uses_the_given_pose():
    """pred_pose_online=False: depth is conditioned on the given pose,
    which is exactly the GT-pose route's depth for that pose."""
    ref, tgt, K, pose_gt = _inputs()
    cfg = TConfig.kitti().override(**dict(OVER, pred_pose_online=False))
    net = TSFMNet(cfg, device="cpu", seed=4)
    args = [torch.from_numpy(a) for a in (ref, tgt, K)]
    out = net(*args, pred_pose=torch.from_numpy(pose_gt))
    ref_out = net(*args, pose_gt=torch.from_numpy(pose_gt), use_gt_pose=True)
    torch.testing.assert_close(out["pose"], torch.from_numpy(pose_gt))
    torch.testing.assert_close(out["depth"], ref_out["depth"], rtol=0, atol=0)


@pytest.fixture(scope="module")
def pwc_run():
    """The PWC-DC route (no confidence: the uniform sampler), float64
    candidates, injected draws: (JAX outputs, port outputs)."""
    ref, tgt, K, _ = _inputs(1)
    over = dict(OVER, **{"pose.solve_dtype": "float64", "flow.estimator": "PWC"})
    jcfg, tcfg = JConfig.kitti().override(**over), TConfig.kitti().override(**over)
    jnet = JSFMNet(jcfg)
    args = [jnp.asarray(a) for a in (ref, tgt, K)]
    variables = random_variables(lambda r, t, k: jnet.init(
        jax.random.PRNGKey(1), r, t, k, key=jax.random.PRNGKey(2)), *args, seed=6)
    key = jax.random.PRNGKey(7)
    jout = jax.jit(lambda v, r, t, k, kk: jnet.apply(v, r, t, k, key=kk))(variables, *args, key)
    tnet = TSFMNet(tcfg, device="cpu")
    load_strict(tnet, jax_params_to_torch(variables, flow_estimator="PWC"))
    tout = tnet(*(torch.from_numpy(a) for a in (ref, tgt, K)), draws=_draws(key, tcfg, 1))
    return ({k: np.asarray(v) for k, v in jout.items() if v is not None},
            {k: t2n(v) for k, v in tout.items() if v is not None})


def test_pwc_route_matches_jax(pwc_run):
    """Flow to 1e-3 px, the same inlier count, pose to 1e-5, depth to 1e-4
    relative (the DICL route's tolerances above); no confidence counts."""
    jout, tout = pwc_run
    assert set(tout) == set(jout) and "num_matches" not in tout
    np.testing.assert_allclose(tout["flow"], jout["flow"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tout["inliers"], jout["inliers"])
    np.testing.assert_allclose(tout["pose"], jout["pose"], rtol=0, atol=1e-5)
    for which in ("depth_init", "depth"):
        np.testing.assert_allclose(tout[which], jout[which], rtol=1e-4, atol=1e-4)


def test_pwc_route_is_supported():
    net = TSFMNet(TConfig.kitti().override(**dict(OVER, **{"flow.estimator": "PWC"})),
                  device="cpu")
    assert type(net.flow_estimator).__name__ == "PWCDCNet"


@pytest.mark.parametrize("over", [{"depth.estimator": "REG2D"}, {"depth.estimator": "DISPNET"},
                                  {"pose.differentiable": True}])
def test_routes_outside_the_slice_raise(over):
    with pytest.raises(NotImplementedError):
        TSFMNet(TConfig.kitti().override(**over), device="cpu")


def test_entry_point_without_cuda_raises():
    """The entry point defaults to the GPU and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSFMNet(TConfig.kitti().override(**OVER))
