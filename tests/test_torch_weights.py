"""The weight bridge (JAX variables -> the port's state dict) and the port's
independence from JAX.

The model-level parity tests (test_torch_psnet/dicl/sfmnet) already run
every converted tensor; these check the bridge's structure and its two
hazards on their own, and that the port imports no JAX.
"""

import os
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, random_variables, t2n

from deep_sfm_revisited_tpu.config import SfMConfig as JConfig
from deep_sfm_revisited_tpu.models.sfmnet import SFMNet as JSFMNet
from deep_sfm_revisited_tpu.utils import torch_port
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.models import dicl as tdicl
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet as TSFMNet
from deep_sfm_revisited_tpu_torch.utils import weights

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
OVER = {"depth.nlabel": 8, "pose.num_hypotheses": 16, "pose.ransac_iter": 1,
        "pose.num_correspondences": 128}


@pytest.fixture(scope="module")
def sfm_variables():
    cfg = JConfig.kitti().override(**OVER)
    net = JSFMNet(cfg)
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    K = jnp.asarray([[[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]]], jnp.float32)
    return random_variables(lambda r, t, k: net.init(
        jax.random.PRNGKey(0), r, t, k, key=jax.random.PRNGKey(1)), x, x, K, seed=2)


def test_state_dict_loads_strictly(sfm_variables):
    """JAX init -> bridge -> load_state_dict(strict=True): no missing, no
    unexpected key, under the reference's module names."""
    sd = weights.jax_params_to_torch(sfm_variables)
    net = TSFMNet(TConfig.kitti().override(**OVER), device="cpu")
    load_strict(net, sd)
    assert all(k.startswith(("flow_estimator.", "depth_estimator.")) for k in sd)
    assert "flow_estimator.cost_smooth2.smooth_layer.conv.weight" in sd
    assert "depth_estimator.feature_extraction.firstconv.0.0.weight" in sd


def test_every_jax_leaf_is_converted(sfm_variables):
    """Each flax leaf feeds exactly one torch tensor: the bridge's tables
    cover the whole DICL + PSNet tree."""
    sd = weights.jax_params_to_torch(sfm_variables)
    n_leaves = len(jax.tree_util.tree_leaves(sfm_variables))
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_bn == n_leaves


def test_pwc_state_dict_loads_strictly():
    """The PWC-DC route: every flax leaf of the JAX SFMNet (PWC-DC + PSNet)
    feeds one tensor of the port's state dict, which loads strictly."""
    over = dict(OVER, **{"flow.estimator": "PWC"})
    net = JSFMNet(JConfig.kitti().override(**over))
    x = jnp.zeros((1, 64, 128, 3), jnp.float32)
    K = jnp.asarray([[[100.0, 0, 64], [0, 100.0, 32], [0, 0, 1]]], jnp.float32)
    variables = random_variables(lambda r, t, k: net.init(
        jax.random.PRNGKey(0), r, t, k, key=jax.random.PRNGKey(1)), x, x, K, seed=5)
    sd = weights.jax_params_to_torch(variables, flow_estimator="PWC")
    load_strict(TSFMNet(TConfig.kitti().override(**over), device="cpu"), sd)
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_bn == len(jax.tree_util.tree_leaves(variables))
    assert sum(k.startswith("flow_estimator.") for k in sd) == 126


def test_bridge_inverts_the_jax_converter(sfm_variables):
    """Round trip: the port's state dict, fed to the JAX package's own
    reference-checkpoint converter, rebuilds the same flax variables."""
    sd = {k: v.numpy() for k, v in weights.jax_params_to_torch(sfm_variables).items()}
    back, report = torch_port.convert_reference_checkpoint(sd, sfm_variables)
    assert not report["missing"]
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(sfm_variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def posenet_variables():
    over = dict(OVER, **{"pose.estimator": "POSENET"})
    net = JSFMNet(JConfig.kitti().override(**over))
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    K = jnp.asarray([[[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]]], jnp.float32)
    return over, random_variables(lambda r, t, k: net.init(
        jax.random.PRNGKey(0), r, t, k, key=jax.random.PRNGKey(1)), x, x, K, seed=6)


def test_posenet_state_dict_loads_strictly_and_inverts(posenet_variables):
    """The POSENET route: every flax leaf (DICL + PSNet + PlainPose) feeds
    one tensor of the port's state dict, which loads strictly; the JAX
    package's converter with `pose="POSENET"` rebuilds the variables."""
    over, variables = posenet_variables
    sd = weights.jax_params_to_torch(variables)
    load_strict(TSFMNet(TConfig.kitti().override(**over), device="cpu"), sd)
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_bn == len(jax.tree_util.tree_leaves(variables))
    assert sum(k.startswith("posenet.") for k in sd) == 12 * 7 + 2   # 12 conv + BN, the head
    back, report = torch_port.convert_reference_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, variables, pose="POSENET")
    assert not report["missing"]
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("pose", [None, "POSENET"])
def test_reference_state_carries_the_pose_net_when_asked(posenet_variables, pose):
    """`load_reference_state` loads `posenet.*` only with pose="POSENET"
    (the CLI passes none, as the JAX CLI's converter call); without it the
    pose net keeps its weights and its keys are reported unused."""
    over, variables = posenet_variables
    sd = weights.jax_params_to_torch(variables)
    net = TSFMNet(TConfig.kitti().override(**over), device="cpu", seed=3)
    before = {k: v.clone() for k, v in net.posenet.state_dict().items()}
    report = weights.load_reference_state(net, sd, "DICL", "PSNET", pose=pose)
    pose_keys = {k for k in sd if k.startswith("posenet.")
                 and not k.endswith("num_batches_tracked")}
    unused = {k for k in report["unused"] if not k.endswith("num_batches_tracked")}
    assert not report["missing"]
    if pose is None:
        assert unused == pose_keys
        assert all(torch.equal(v, before[k]) for k, v in net.posenet.state_dict().items())
    else:
        assert not unused and pose_keys <= set(report["consumed"])
        for k, v in net.posenet.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, sd[f"posenet.{k}"]), k


@pytest.mark.parametrize("depth", ["PANET", "REGNET"])
def test_depth_alternate_state_dict_loads_strictly_and_inverts(depth):
    """PANet and REGNet (DICL flow): every flax leaf of the JAX SFMNet feeds
    one tensor of the port's state dict, which loads strictly; the JAX
    package's own tables (`torch_port.apply_entries`) rebuild the variables
    from it; and
    `load_reference_state` takes every key (`--pretrained-torch` stays
    PSNet's only, as the JAX CLI's)."""
    over = dict(OVER, **{"depth.estimator": depth})
    net = JSFMNet(JConfig.kitti().override(**over))
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    K = jnp.asarray([[[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]]], jnp.float32)
    variables = random_variables(lambda r, t, k: net.init(
        jax.random.PRNGKey(0), r, t, k, key=jax.random.PRNGKey(1)), x, x, K, seed=9)
    sd = weights.jax_params_to_torch(variables, depth_estimator=depth)
    load_strict(TSFMNet(TConfig.kitti().override(**over), device="cpu"), sd)
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_bn == len(jax.tree_util.tree_leaves(variables))
    jtable = {"PANET": torch_port.panet_entries, "REGNET": torch_port.regnet_entries}[depth]
    back, report = torch_port.apply_entries(
        {k: v.numpy() for k, v in sd.items()}, variables,
        torch_port.dicl_entries("flow_estimator", "flow_net")
        + jtable("depth_estimator", "depth_net"))
    assert not report["missing"]
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    fresh = TSFMNet(TConfig.kitti().override(**over), device="cpu", seed=4)
    report = weights.load_reference_state(fresh, sd, "DICL", depth)
    assert not report["missing"] and all(k.endswith("num_batches_tracked")
                                         for k in report["unused"])
    for k, v in fresh.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k


def test_deconv_flip_matches_flax():
    """Flax ConvTranspose(k4, s2, SAME) == torch ConvTranspose2d(k4, s2, p1)
    with the bridge's channel swap and spatial flip."""
    x = np.random.RandomState(3).randn(1, 5, 6, 8).astype(np.float32)
    m = fnn.ConvTranspose(4, (4, 4), strides=(2, 2), padding="SAME", use_bias=False)
    v = m.init(jax.random.PRNGKey(4), jnp.asarray(x))
    ref = np.asarray(m.apply(v, jnp.asarray(x)))
    conv = tdicl.BasicConv(8, 4, 4, 2, deconv=True, bn=False, relu=False)
    w = weights._torch_weight("deconv2d", np.asarray(v["params"]["kernel"]))
    conv.conv.weight.data = torch.from_numpy(np.ascontiguousarray(w))
    got = t2n(conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_smooth_cost_applies_the_jax_displacement_order():
    """A JAX smoothing kernel that moves displacement (dv=1, du=0) onto
    (dv=0, du=1), through the bridge, does the same in the port."""
    S, s2 = 3, 9
    k = np.zeros((1, 1, s2, s2), np.float32)
    src, dst = (1 + 1) * S + (0 + 1), (0 + 1) * S + (1 + 1)   # dv outer, du inner
    k[0, 0, src, dst] = 1.0
    sm = tdicl.SmoothCost(s2)
    sm.smooth_layer.conv.weight.data = torch.from_numpy(
        np.ascontiguousarray(weights._torch_weight("conv2d_disp_transpose", k)))
    cost = torch.zeros(1, s2, 2, 2)
    cost[0, src] = 1.0
    out = sm(cost).detach()
    assert float(out[0, dst].min()) == 1.0 and float(out.sum()) == 4.0


def test_port_imports_no_jax():
    """Import every module of the port and chip_smoke in a fresh process:
    neither jax nor the JAX package may be loaded."""
    code = (
        "import importlib, pathlib, sys\n"
        "import deep_sfm_revisited_tpu_torch as p\n"
        "root = pathlib.Path(p.__file__).parent\n"
        "for f in sorted(root.rglob('*.py')):\n"
        "    parts = f.relative_to(root).with_suffix('').parts\n"
        "    parts = parts[:-1] if parts[-1] == '__init__' else parts\n"
        "    importlib.import_module('.'.join((p.__name__,) + parts))\n"
        "import chip_smoke\n"
        "need = ['cli', 'models.pwcnet', 'ops.correlation', 'ops.cuda.local_corr',\n"
        "        'data.png', 'data.kitti', 'train.evaluate', 'train.metrics',\n"
        "        'models.posenet', 'train.odometry', 'train.pose_eval', 'data.velodyne',\n"
        "        'data.flow_io', 'data.flow_augment', 'data.flow_datasets',\n"
        "        'train.flow_trainer', 'train.flow_eval', 'models.depth_alternates',\n"
        "        'ops.cuda.sweep_corr']\n"
        "missing = [m for m in need if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax',"
        " 'deep_sfm_revisited_tpu.')) or m == 'deep_sfm_revisited_tpu']\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


@pytest.fixture(scope="module")
def raft_variables():
    over = dict(OVER, **{"flow.estimator": "RAFT"})
    net = JSFMNet(JConfig.kitti().override(**over))
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    K = jnp.asarray([[[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]]], jnp.float32)
    return over, random_variables(lambda r, t, k: net.init(
        jax.random.PRNGKey(0), r, t, k, key=jax.random.PRNGKey(1)), x, x, K, seed=8)


def test_raft_state_dict_loads_strictly(raft_variables):
    """The RAFT route: every flax leaf of the JAX SFMNet (RAFT + PSNet)
    feeds the port's state dict, which loads strictly; each of the three
    fused kernels (z|r twice, the heads' first convolutions) and its bias
    splits into two upstream tensors, and the instance norms' scale and
    bias are carried."""
    over, variables = raft_variables
    sd = weights.jax_params_to_torch(variables, flow_estimator="RAFT")
    load_strict(TSFMNet(TConfig.kitti().override(**over), device="cpu"), sd)
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_bn == len(jax.tree_util.tree_leaves(variables)) + 6
    flow = variables["params"]["flow_net"]
    zr = np.asarray(flow["UpdateBlock_0"]["SepConvGRU_0"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(sd["flow_estimator.update_block.gru.convr1.weight"].numpy(),
                                  np.transpose(zr[..., 128:], (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd["flow_estimator.fnet.layer3.0.downsample.1.weight"].numpy(),
                                  np.asarray(flow["fnet"]["ResBlock_4"]["GroupNorm_2"]["scale"]))


def _reference_raft(sd):
    """A reference-named RAFT checkpoint from the port's state dict:
    upstream's instance norms carry no tensors, conv1 reads BGR, and each
    strided residual block of cnet holds its projection's BatchNorm twice
    (`norm3` and `downsample.1`, one module)."""
    ref = {}
    for k, v in sd.items():
        if k.startswith("flow_estimator.fnet.") and (".norm" in k or "downsample.1" in k):
            continue
        ref[k] = v.flip(1) if k.endswith("net.conv1.weight") else v
    for k in list(ref):
        if k.startswith("flow_estimator.cnet.") and ".downsample.1." in k:
            ref[k.replace("downsample.1", "norm3")] = ref[k]
    return ref


def test_pretrained_torch_loads_a_reference_raft_as_jax_does(raft_variables, tmp_path, capsys):
    """`--pretrained-torch` with a reference-named RAFT checkpoint: the
    report (consumed, missing, unused) is the JAX converter's on the same
    file; the loaded conv1 is JAX's after its BGR permutation, carried back
    to the port; fnet's instance norms stay at identity and are neither
    missing nor unused."""
    from deep_sfm_revisited_tpu_torch import cli

    over, variables = raft_variables
    sd = _reference_raft(weights.jax_params_to_torch(variables, flow_estimator="RAFT"))
    path = str(tmp_path / "raft.pth.tar")
    torch.save({"epoch": 0, "state_dict": sd}, path)
    model = TSFMNet(TConfig.kitti().override(**over), device="cpu")
    report = cli.load_pretrained_torch(path, model, model.cfg)
    jsd = torch_port.load_torch_checkpoint(path)
    back, jreport = torch_port.convert_reference_checkpoint(jsd, variables, flow="RAFT")
    assert sorted(report["missing"]) == sorted(jreport["missing"]) == []
    assert report["unused"] == jreport["unused"]
    assert sorted(report["consumed"]) == sorted(jreport["consumed"])
    assert any(".norm3." in k for k in report["unused"])
    assert not any("fnet" in k and "norm" in k for k in report["unused"])
    state = model.state_dict()
    carried = weights.jax_params_to_torch(back, flow_estimator="RAFT")
    for k in ("flow_estimator.fnet.conv1.weight", "flow_estimator.cnet.conv1.weight"):
        assert torch.equal(state[k], carried[k]), k
        assert torch.equal(state[k], sd[k].flip(1)), k
    for k, v in state.items():
        if k.startswith("flow_estimator.fnet.") and ".norm" in k:
            assert torch.equal(v, torch.ones_like(v) if k.endswith("weight")
                               else torch.zeros_like(v)), k
    assert "torch port:" in capsys.readouterr().out
