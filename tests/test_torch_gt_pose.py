"""`pose.estimator = "GT"` in the port's SFMNet against the JAX composite.

JAX builds the composite with the GT estimator (no pose net,
`sfmnet.py:109-112`), takes the oracle branch under `use_gt_pose=True`
(`:143-150`) and the saved-pose branch under `pred_pose_online=False`
(`:151-162`) before any estimator check, and raises only on an online
forward (`:197`). The port does the same. One set of random weights
(through the bridge; JAX's variables come from the RANSAC composite, whose
tree is the GT one's) at 128x128 (DICL takes /128), nlabel 8, float32:
both routes' depth to 1e-4 relative as `test_torch_sfmnet.py` holds the
GT-pose route, the pose exactly, the flow zero; an online forward raises
NotImplementedError in both.
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

torch.set_num_threads(2)
B, H, W = 1, 128, 128
OVER = {"depth.nlabel": 8, "pose.estimator": "GT"}
ROUTES = {"oracle": {"use_gt_pose": True}, "saved": {"pred_pose_online": False}}


def _inputs():
    rng = np.random.RandomState(0)
    ref = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    tgt = (np.roll(ref, (1, 2), axis=(1, 2)) + 0.05 * rng.randn(B, H, W, 3)).astype(np.float32)
    K = np.array([[[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]], np.float32)
    a = 0.02
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    pose_gt = np.concatenate([R, [[0.3], [0.0], [1.9]]], 1)[None].astype(np.float32)
    pred = np.concatenate([R.T, [[0.1], [0.05], [0.99]]], 1)[None].astype(np.float32)
    return ref, tgt, K, pose_gt, pred


@pytest.fixture(scope="module")
def variables():
    ref, tgt, K, _, _ = _inputs()
    jnet = JSFMNet(JConfig.kitti().override(**{"depth.nlabel": 8}))
    return random_variables(lambda r, t, k: jnet.init(jax.random.PRNGKey(1), r, t, k,
                                                      key=jax.random.PRNGKey(2)),
                            *(jnp.asarray(a) for a in (ref, tgt, K)), seed=3)


def test_the_gt_estimator_builds_no_pose_net():
    net = TSFMNet(TConfig.kitti().override(**OVER), device="cpu")
    assert not hasattr(net, "posenet")
    assert type(net.flow_estimator).__name__ == "DICLFlow"


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_gt_estimator_routes_match_jax(variables, route):
    ref, tgt, K, pose_gt, pred = _inputs()
    over = dict(OVER, **({} if route == "oracle" else ROUTES[route]))
    kw = {"use_gt_pose": True} if route == "oracle" else {}
    jnet = JSFMNet(JConfig.kitti().override(**over))
    jout = jax.jit(lambda v, r, t, k, p, pp: jnet.apply(v, r, t, k, pose_gt=p, pred_pose=pp,
                                                        **kw))(
        variables, *(jnp.asarray(a) for a in (ref, tgt, K, pose_gt, pred)))
    tnet = TSFMNet(TConfig.kitti().override(**over), device="cpu")
    load_strict(tnet, jax_params_to_torch(variables))
    with torch.no_grad():
        tout = tnet(*(torch.from_numpy(a) for a in (ref, tgt, K)),
                    pose_gt=torch.from_numpy(pose_gt), pred_pose=torch.from_numpy(pred), **kw)
    np.testing.assert_array_equal(t2n(tout["pose"]), np.asarray(jout["pose"]))
    assert not np.any(t2n(tout["flow"])) and not np.any(np.asarray(jout["flow"]))
    assert tout["inliers"] is None and jout["inliers"] is None
    for which in ("depth_init", "depth"):
        got, want = t2n(tout[which]), np.asarray(jout[which])
        assert got.shape == (B, H, W) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=which)


def test_an_online_gt_forward_raises_as_in_jax(variables):
    ref, tgt, K, pose_gt, _ = _inputs()
    jnet = JSFMNet(JConfig.kitti().override(**OVER))
    with pytest.raises(NotImplementedError):
        jax.eval_shape(lambda v, r, t, k: jnet.apply(v, r, t, k, key=jax.random.PRNGKey(0)),
                       variables, *(jnp.asarray(a) for a in (ref, tgt, K)))
    tnet = TSFMNet(TConfig.kitti().override(**OVER), device="cpu")
    with pytest.raises(NotImplementedError, match="GT"):
        tnet(*(torch.from_numpy(a) for a in (ref, tgt, K)), pose_gt=torch.from_numpy(pose_gt))
