"""Weight bridge: JAX package variables -> the port's torch state dict.

The port's modules carry the reference's names (`flow_estimator.*`,
`depth_estimator.*`, `posenet.*`), so a reference `kitti.pth.tar` loads with a plain
`load_state_dict`, and the JAX package's own converter
(`deep_sfm_revisited_tpu/utils/torch_port.py`) maps reference tensors onto
flax variables through explicit entry tables. This module keeps a COPY of
those tables (the port imports nothing of the JAX package), adds one for
PWC-DC (which `torch_port.py` lacks; upstream PWC-Net's names), and runs
each transform in reverse:

  conv2d                 flax (kh, kw, I, O)        -> torch (O, I, kh, kw)
  conv3d                 flax (kd, kh, kw, I, O)    -> torch (O, I, kd, kh, kw)
  conv2d_to_3d           flax (1, kh, kw, I, O)     -> torch Conv2d (O, I, kh, kw)
  deconv2d               flax ConvTranspose (kh, kw, I, O), spatially
                         flipped                    -> torch (I, O, kh, kw)
  conv2d_disp_transpose  DICL cost smoothing: the displacement axes are
                         permuted from the JAX order (dv outer, du inner)
                         to the reference's (du outer, dv inner)
  bn                     scale/bias/mean/var        -> weight/bias/running_*
                         (plus num_batches_tracked = 0)
  gn                     flax GroupNorm scale/bias  -> weight/bias (RAFT's
                         affine instance norms, which the JAX table leaves
                         at identity and a reference checkpoint lacks)
  conv2d_bgr             as conv2d: JAX's kernel already reads RGB (a
                         reference tensor reads BGR and is permuted when
                         `load_reference_state` loads it)
  conv2d_cat             RAFT's fused z|r and heads kernels, split evenly
                         along Cout into the upstream modules' tensors

Input: the flax variables as nested dicts of arrays (numpy or anything
`np.asarray` takes), {"params": ..., "batch_stats": ...}.

`load_reference_state` reads the same tables the other way round: it loads
the keys of a reference state dict that the tables cover into the port's
model and reports the rest, as the JAX package's
`torch_port.convert_reference_checkpoint` does (the reference's
`strict=False`, `main.py:203`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

# (kind, torch module prefix, flax path); a `conv2d_cat` entry names a tuple
# of torch module prefixes
Entry = Tuple[str, Any, str]


# ---- entry tables (copied from deep_sfm_revisited_tpu/utils/torch_port.py) --

def _convbn2d(t: str, f: str) -> List[Entry]:
    return [("conv2d", f"{t}.0", f"{f}/Conv_0"), ("bn", f"{t}.1", f"{f}/BatchNorm_0")]


def _convbn3d(t: str, f: str) -> List[Entry]:
    return [("conv3d", f"{t}.0", f"{f}/Conv3DMXU_0"), ("bn", f"{t}.1", f"{f}/BatchNorm_0")]


def spp_entries(t: str, f: str) -> List[Entry]:
    """`feature_extraction` SPP encoder (torch_port.py:206)."""
    e: List[Entry] = []
    for i, j in enumerate((0, 2, 4)):
        e += _convbn2d(f"{t}.firstconv.{j}", f"{f}/ConvBN_{i}")
    blk = 0
    for layer, blocks, down in (("layer1", 3, False), ("layer2", 16, True),
                                ("layer3", 3, True), ("layer4", 3, False)):
        for b in range(blocks):
            tb = f"{t}.{layer}.{b}"
            fb = f"{f}/BasicBlock_{blk}"
            e += _convbn2d(f"{tb}.conv1.0", f"{fb}/ConvBN_0")
            e += _convbn2d(f"{tb}.conv2", f"{fb}/ConvBN_1")
            if b == 0 and down:
                e += [("conv2d", f"{tb}.downsample.0", f"{fb}/Conv_0"),
                      ("bn", f"{tb}.downsample.1", f"{fb}/BatchNorm_0")]
            blk += 1
    for i in range(4):
        e += _convbn2d(f"{t}.branch{i + 1}.1", f"{f}/ConvBN_{3 + i}")
    e += _convbn2d(f"{t}.lastconv.0", f"{f}/ConvBN_7")
    e += [("conv2d", f"{t}.lastconv.2", f"{f}/Conv_0")]
    return e


def context_entries(t: str, f: str, context_bn: bool = False) -> List[Entry]:
    """The per-plane convtext stack `convs` (ref PSNet.py:64-72), a (1, k, k)
    3D ContextNet in JAX (torch_port.py:268, `_context_2d_to_3d`)."""
    e: List[Entry] = []
    for i in range(7):
        e += [("conv2d_to_3d", f"{t}.{i}.0", f"{f}/Conv3DMXU_{i}")]
        if context_bn:
            e += [("bn", f"{t}.{i}.1", f"{f}/BatchNorm_{i}")]
    return e


def psnet_entries(t: str = "depth_estimator", f: str = "depth_net",
                  context_bn: bool = False, dep_context: bool = True) -> List[Entry]:
    """PSNet (torch_port.py:232)."""
    e = spp_entries(f"{t}.feature_extraction", f"{f}/SPPFeatureExtractor_0")
    hg = f"{f}/Hourglass3D_0"
    e += _convbn3d(f"{t}.dres0.0", f"{hg}/ConvBN3D_0")
    e += _convbn3d(f"{t}.dres0.2", f"{hg}/ConvBN3D_1")
    idx = 2
    for dres in ("dres1", "dres2", "dres3", "dres4"):
        e += _convbn3d(f"{t}.{dres}.0", f"{hg}/ConvBN3D_{idx}")
        e += _convbn3d(f"{t}.{dres}.2", f"{hg}/ConvBN3D_{idx + 1}")
        idx += 2
    e += _convbn3d(f"{t}.classify.0", f"{hg}/ConvBN3D_10")
    e += [("conv3d", f"{t}.classify.2", f"{hg}/Conv3DMXU_0")]
    e += context_entries(f"{t}.convs", f"{f}/ContextNet_0", context_bn)
    if dep_context:
        for i in range(7):
            e += [("conv2d", f"{t}.dep_convs.{i}.0", f"{f}/DepthContextNet_0/Conv_{i}")]
            if context_bn:
                e += [("bn", f"{t}.dep_convs.{i}.1",
                       f"{f}/DepthContextNet_0/BatchNorm_{i}")]
    return e


def _basicconv(t: str, f: str, bn: bool = True, deconv: bool = False) -> List[Entry]:
    conv_name = "ConvTranspose_0" if deconv else "Conv_0"
    e: List[Entry] = [("deconv2d" if deconv else "conv2d", f"{t}.conv", f"{f}/{conv_name}")]
    if bn:
        e.append(("bn", f"{t}.bn", f"{f}/BatchNorm_0"))
    return e


def _conv2x(t: str, f: str, deconv: bool = False) -> List[Entry]:
    return (_basicconv(f"{t}.conv1", f"{f}/BasicConv_0", bn=False, deconv=deconv)
            + _basicconv(f"{t}.conv2", f"{f}/BasicConv_1", bn=True))


def featurega_entries(t: str, f: str) -> List[Entry]:
    """`FeatureGA` U-net (torch_port.py:454)."""
    e: List[Entry] = []
    for i in range(3):
        e += _basicconv(f"{t}.conv_start.{i}", f"{f}/BasicConv_{i}")
    for i, name in enumerate(("conv1a", "conv2a", "conv3a", "conv4a", "conv5a", "conv6a")):
        e += _basicconv(f"{t}.{name}", f"{f}/BasicConv_{3 + i}")
    for i, name in enumerate(("deconv6a", "deconv5a", "deconv4a", "deconv3a",
                              "deconv2a", "deconv1a")):
        e += _conv2x(f"{t}.{name}", f"{f}/Conv2x_{i}", deconv=True)
    for i, name in enumerate(("conv1b", "conv2b", "conv3b", "conv4b", "conv5b")):
        e += _conv2x(f"{t}.{name}", f"{f}/Conv2x_{6 + i}")
    e += _conv2x(f"{t}.conv6b", f"{f}/Conv2x_11")
    for i, (dec, out) in enumerate((("deconv6b", "outconv_6"), ("deconv5b", "outconv_5"),
                                    ("deconv4b", "outconv_4"), ("deconv3b", "outconv_3"),
                                    ("deconv2b", "outconv_2"))):
        e += _conv2x(f"{t}.{dec}", f"{f}/Conv2x_{12 + i}", deconv=True)
        e += _basicconv(f"{t}.{out}", f"{f}/BasicConv_{9 + i}")
    return e


def dicl_entries(t: str = "flow_estimator", f: str = "flow_net") -> List[Entry]:
    """`DICL_shallow` at the KITTI recipe (torch_port.py:486)."""
    e = featurega_entries(f"{t}.feature", f"{f}/FeatureGA_0")
    for li, lvl in enumerate((6, 5, 4, 3, 2)):
        m_t, m_f = f"{t}.matching{lvl}.match", f"{f}/matching{lvl}"
        for i in range(4):
            e += _basicconv(f"{m_t}.{i}", f"{m_f}/BasicConv_{i}")
        e += _basicconv(f"{m_t}.4", f"{m_f}/BasicConv_4", deconv=True)
        e += [("conv2d", f"{m_t}.5", f"{m_f}/Conv_0")]
        e += [("conv2d_disp_transpose", f"{t}.cost_smooth{lvl}.smooth_layer.conv",
               f"{f}/Conv_{2 * li}")]
        for i in range(6):
            e += _basicconv(f"{t}.context{lvl}.{i}", f"{f}/BasicConv_{6 * li + i}")
        e += [("conv2d", f"{t}.context{lvl}.6", f"{f}/Conv_{2 * li + 1}")]
    return e


def pwc_encoder_names(lvl: int) -> Tuple[str, str, str]:
    """Upstream PWC-Net's three encoder convs of pyramid level 1..6 (the
    stride-2 one first; level 6 names them in another order)."""
    if lvl == 6:
        return ("conv6aa", "conv6a", "conv6b")
    return (f"conv{lvl}a", f"conv{lvl}aa", f"conv{lvl}b")


def pwc_entries(t: str = "flow_estimator", f: str = "flow_net") -> List[Entry]:
    """`PWCDCNet` (JAX `models/pwcnet.py`) under upstream PWC-Net's names:
    126 flax leaves. Flax names its submodules by creation order: the
    shared `_Encoder_0` (18 convs), `_DenseDecoder_{0..4}` for levels 6..2,
    `_Deconv_{2i}`/`_Deconv_{2i+1}` for the up-flow/up-feature of level 6-i,
    and the context net's `_Conv_{0..5}` and `Conv_0`."""
    e: List[Entry] = []
    for lvl in range(1, 7):
        for j, name in enumerate(pwc_encoder_names(lvl)):
            e.append(("conv2d", f"{t}.{name}.0",
                      f"{f}/_Encoder_0/_Conv_{3 * (lvl - 1) + j}/Conv_0"))
    for i, lvl in enumerate((6, 5, 4, 3, 2)):
        dec = f"{f}/_DenseDecoder_{i}"
        for k in range(5):
            e.append(("conv2d", f"{t}.conv{lvl}_{k}.0", f"{dec}/_Conv_{k}/Conv_0"))
        e.append(("conv2d", f"{t}.predict_flow{lvl}", f"{dec}/Conv_0"))
        if lvl > 2:
            e.append(("deconv2d", f"{t}.deconv{lvl}", f"{f}/_Deconv_{2 * i}/ConvTranspose_0"))
            e.append(("deconv2d", f"{t}.upfeat{lvl}",
                      f"{f}/_Deconv_{2 * i + 1}/ConvTranspose_0"))
    for k in range(6):
        e.append(("conv2d", f"{t}.dc_conv{k + 1}.0", f"{f}/_Conv_{k}/Conv_0"))
    e.append(("conv2d", f"{t}.dc_conv7", f"{f}/Conv_0"))
    return e


# RAFT's norms: the entry kind and flax module name of each
_RAFT_NORMS = {"batch": ("bn", "BatchNorm"), "instance": ("gn", "GroupNorm")}


def _resblock(t: str, f: str, norm: str, down: bool) -> List[Entry]:
    """RAFT's `ResidualBlock` (torch_port.py:570), plus the instance norms'
    GroupNorm tensors, which the JAX table leaves out."""
    e: List[Entry] = [("conv2d", f"{t}.conv1", f"{f}/Conv_0"),
                      ("conv2d", f"{t}.conv2", f"{f}/Conv_1")]
    kind, flax = _RAFT_NORMS.get(norm, (None, None))
    if kind:
        e += [(kind, f"{t}.norm1", f"{f}/{flax}_0"), (kind, f"{t}.norm2", f"{f}/{flax}_1")]
    if down:
        e += [("conv2d", f"{t}.downsample.0", f"{f}/Conv_2")]
        if kind:
            e += [(kind, f"{t}.downsample.1", f"{f}/{flax}_2")]
    return e


def basic_encoder_entries(t: str, f: str, norm: str) -> List[Entry]:
    """RAFT's `BasicEncoder` (torch_port.py:586); conv1 is `conv2d_bgr`."""
    e: List[Entry] = [("conv2d_bgr", f"{t}.conv1", f"{f}/Conv_0")]
    kind, flax = _RAFT_NORMS.get(norm, (None, None))
    if kind:
        e += [(kind, f"{t}.norm1", f"{f}/{flax}_0")]
    blk = 0
    for layer in ("layer1", "layer2", "layer3"):
        for b in range(2):
            down = layer != "layer1" and b == 0
            e += _resblock(f"{t}.{layer}.{b}", f"{f}/ResBlock_{blk}", norm, down)
            blk += 1
    e += [("conv2d", f"{t}.conv2", f"{f}/Conv_1")]
    return e


def raft_entries(t: str = "flow_estimator", f: str = "flow_net") -> List[Entry]:
    """RAFT (torch_port.py:608): fnet, cnet and the update block; the
    `conv2d_cat` entries name a tuple of torch modules whose weights JAX
    concatenates along Cout."""
    e = basic_encoder_entries(f"{t}.fnet", f"{f}/fnet", "instance")
    e += basic_encoder_entries(f"{t}.cnet", f"{f}/cnet", "batch")
    u_t, u_f = f"{t}.update_block", f"{f}/UpdateBlock_0"
    me = f"{u_f}/MotionEncoder_0"
    for i, name in enumerate(("convc1", "convc2", "convf1", "convf2", "conv")):
        e += [("conv2d", f"{u_t}.encoder.{name}", f"{me}/Conv_{i}")]
    gru = f"{u_f}/SepConvGRU_0"
    e += [("conv2d_cat", (f"{u_t}.gru.convz1", f"{u_t}.gru.convr1"), f"{gru}/Conv_0"),
          ("conv2d", f"{u_t}.gru.convq1", f"{gru}/Conv_1"),
          ("conv2d_cat", (f"{u_t}.gru.convz2", f"{u_t}.gru.convr2"), f"{gru}/Conv_2"),
          ("conv2d", f"{u_t}.gru.convq2", f"{gru}/Conv_3"),
          ("conv2d_cat", (f"{u_t}.flow_head.conv1", f"{u_t}.mask.0"), f"{u_f}/Conv_0"),
          ("conv2d", f"{u_t}.flow_head.conv2", f"{u_f}/Conv_1"),
          ("conv2d", f"{u_t}.mask.2", f"{u_f}/Conv_2")]
    return e


def plainpose_entries(t: str = "posenet", f: str = "pose_net") -> List[Entry]:
    """`PlainPose` (torch_port.py:633): biased conv + BN + ReLU stacks,
    `posenet.conv.{i}` (the shared frame encoder), `posenet.pose_agg.{i}`
    and the 1x1 head `posenet.pose_reg`."""
    e: List[Entry] = []
    for i in range(7):
        e += _convbn2d(f"{t}.conv.{i}", f"{f}/frame_enc/_ConvBNRelu_{i}")
    for i in range(5):
        e += _convbn2d(f"{t}.pose_agg.{i}", f"{f}/_ConvBNRelu_{i}")
    e += [("conv2d", f"{t}.pose_reg", f"{f}/Conv_0")]
    return e


# ---- the reverse transforms ------------------------------------------------

def panet_entries(t: str = "depth_estimator", f: str = "depth_net",
                  context_bn: bool = False) -> List[Entry]:
    """PANet (torch_port.py:286): SPP + dres00-03/classify0 + convs."""
    e = spp_entries(f"{t}.feature_extraction", f"{f}/SPPFeatureExtractor_0")
    hg = f"{f}/SmallHourglass3D_0"
    e += _convbn3d(f"{t}.dres00.0", f"{hg}/ConvBN3D_0")
    e += _convbn3d(f"{t}.dres00.2", f"{hg}/ConvBN3D_1")
    idx = 2
    for dres in ("dres01", "dres02", "dres03"):
        e += _convbn3d(f"{t}.{dres}.0", f"{hg}/ConvBN3D_{idx}")
        e += _convbn3d(f"{t}.{dres}.2", f"{hg}/ConvBN3D_{idx + 1}")
        idx += 2
    e += _convbn3d(f"{t}.classify0.0", f"{hg}/ConvBN3D_8")
    e += [("conv3d", f"{t}.classify0.2", f"{hg}/Conv3DMXU_0")]
    return e + context_entries(f"{t}.convs", f"{f}/ContextNet_0", context_bn)


def regnet_entries(t: str = "depth_estimator", f: str = "depth_net",
                   context_bn: bool = False) -> List[Entry]:
    """REGNet (torch_port.py:304): SPP + posecnn0-4/predict + convs."""
    e = spp_entries(f"{t}.feature_extraction", f"{f}/SPPFeatureExtractor_0")
    e += _convbn3d(f"{t}.posecnn0.0", f"{f}/ConvBN3D_0")
    e += _convbn3d(f"{t}.posecnn0.2", f"{f}/ConvBN3D_1")
    idx = 2
    for p in ("posecnn1", "posecnn2", "posecnn3", "posecnn4"):
        e += _convbn3d(f"{t}.{p}.0", f"{f}/ConvBN3D_{idx}")
        e += _convbn3d(f"{t}.{p}.2", f"{f}/ConvBN3D_{idx + 1}")
        idx += 2
    e += _convbn3d(f"{t}.predict.0", f"{f}/ConvBN3D_10")
    e += [("conv3d", f"{t}.predict.2", f"{f}/Conv3DMXU_0")]
    return e + context_entries(f"{t}.convs", f"{f}/ContextNet_0", context_bn)


def depth_entries(depth: str, t: str = "depth_estimator", f: str = "depth_net",
                  context_bn: bool = False, dep_context: bool = True) -> List[Entry]:
    """The weight table of depth net `depth` (a key of DEPTH_ENTRIES);
    `dep_context` is PSNet's alone."""
    if depth not in DEPTH_ENTRIES:
        raise KeyError(f"no weight table for depth estimator {depth}")
    if depth == "PSNET":
        return psnet_entries(t, f, context_bn=context_bn, dep_context=dep_context)
    return DEPTH_ENTRIES[depth](t, f, context_bn=context_bn)


def disp_transpose_perm(s2: int) -> np.ndarray:
    """The (u, v) <-> (v, u) displacement permutation (an involution)."""
    S = int(round(s2 ** 0.5))
    return np.arange(s2).reshape(S, S).T.ravel()


def _get(tree, path: Sequence[str]):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _has(tree, path: Sequence[str]) -> bool:
    for p in path:
        if not hasattr(tree, "keys") or p not in tree:
            return False
        tree = tree[p]
    return True


def _torch_weight(kind: str, w: np.ndarray) -> np.ndarray:
    if kind in ("conv2d", "conv2d_bgr"):
        return np.transpose(w, (3, 2, 0, 1))
    if kind == "conv3d":
        return np.transpose(w, (4, 3, 0, 1, 2))
    if kind == "conv2d_to_3d":
        return np.transpose(w[0], (3, 2, 0, 1))
    if kind == "deconv2d":
        return np.transpose(w[::-1, ::-1], (2, 3, 0, 1))
    if kind == "conv2d_disp_transpose":
        perm = disp_transpose_perm(w.shape[-1])
        return np.transpose(w[:, :, perm][:, :, :, perm], (3, 2, 0, 1))
    raise KeyError(kind)


def convert(variables: Dict[str, Any], entries: Sequence[Entry]) -> Dict[str, torch.Tensor]:
    """Run `entries` in reverse over flax `variables` -> {torch key: tensor}.

    Raises KeyError on a flax path the table names but `variables` lacks.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key.lstrip(".")] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))

    for kind, tkey, fpath in entries:
        parts = tuple(p for p in fpath.split("/") if p)
        if kind == "conv2d_cat":
            n = len(tkey)
            ws = np.split(_torch_weight("conv2d", _get(params, parts + ("kernel",))), n, axis=0)
            bs = (np.split(_get(params, parts + ("bias",)), n)
                  if _has(params, parts + ("bias",)) else [None] * n)
            for key, w, b in zip(tkey, ws, bs):
                put(f"{key}.weight", w)
                if b is not None:
                    put(f"{key}.bias", b)
            continue
        if kind == "gn":
            put(f"{tkey}.weight", _get(params, parts + ("scale",)))
            put(f"{tkey}.bias", _get(params, parts + ("bias",)))
            continue
        if kind == "bn":
            put(f"{tkey}.weight", _get(params, parts + ("scale",)))
            put(f"{tkey}.bias", _get(params, parts + ("bias",)))
            put(f"{tkey}.running_mean", _get(stats, parts + ("mean",)))
            put(f"{tkey}.running_var", _get(stats, parts + ("var",)))
            sd[f"{tkey}.num_batches_tracked".lstrip(".")] = torch.tensor(0)
            continue
        put(f"{tkey}.weight", _torch_weight(kind, _get(params, parts + ("kernel",))))
        if _has(params, parts + ("bias",)):
            put(f"{tkey}.bias", _get(params, parts + ("bias",)))
    return sd


FLOW_ENTRIES = {"DICL": dicl_entries, "PWC": pwc_entries, "RAFT": raft_entries}
DEPTH_ENTRIES = {"PSNET": psnet_entries, "PANET": panet_entries, "REGNET": regnet_entries}


def jax_params_to_torch(variables: Dict[str, Any], context_bn: bool = False,
                        dep_context: bool = True, flow_estimator: str = "DICL",
                        depth_estimator: str = "PSNET") -> Dict[str, torch.Tensor]:
    """State dict of the port's `SFMNet` (DICL, PWC-DC or RAFT flow + PSNet,
    PANet or REGNet, and PoseNet where the variables hold a `pose_net`, the
    POSENET route) from the JAX `SFMNet` variables, under the reference's
    module names."""
    entries = FLOW_ENTRIES[flow_estimator]() + depth_entries(
        depth_estimator, context_bn=context_bn, dep_context=dep_context)
    if "pose_net" in variables["params"]:
        entries += plainpose_entries()
    return convert(variables, entries)


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A state dict under the reference's module names from `path`: the
    reference's {'epoch', 'state_dict'} wrapper is unwrapped and
    DataParallel `module.` prefixes are stripped (as the JAX package's
    `torch_port.load_torch_checkpoint`)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


BN_SUFFIXES = ("weight", "bias", "running_mean", "running_var")


def load_reference_state(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
                         flow: str | None, depth: str | None, context_bn: bool = False,
                         dep_context: bool = True,
                         pose: str | None = None) -> Dict[str, List[str]]:
    """Load into `model` the keys of the reference state dict `sd` that the
    weight tables of `flow` (a key of FLOW_ENTRIES, or None), `depth`
    (a key of DEPTH_ENTRIES, or None) and `pose` ("POSENET" or None) cover; a network given
    as None is left untouched (the CLI passes no `pose`, as the JAX CLI's
    converter call does not, `cli.py:207-213`).

    As the JAX package's `convert_reference_checkpoint` (`torch_port.py:
    520-568`): a checkpoint whose flow (depth) keys lack the
    `flow_estimator.` (`depth_estimator.`) prefix is read without it; a
    BN entry takes weight, bias and the running statistics, any other entry
    its weight and, where `sd` has one, its bias; RAFT's `conv2d_cat` entry
    takes its modules' weights, then their biases (a reference names the
    fused modules apart), its `conv2d_bgr` weight is permuted from the
    reference's BGR input channels to the port's RGB, and its GroupNorm
    (`gn`) entries are skipped: a reference's instance norms carry no
    tensors, so they stay at identity, as in JAX. Returns {"consumed",
    "missing", "unused"}: the keys loaded, the keys a table wants that `sd`
    lacks, and the keys of `sd` no table took. A shape that differs from
    the model's raises.
    """
    tables = []
    if flow is not None:
        prefix = "flow_estimator" if any(k.startswith("flow_estimator.") for k in sd) else ""
        tables.append((FLOW_ENTRIES[flow](prefix, "flow_net"), prefix, "flow_estimator"))
    if depth is not None:
        prefix = "depth_estimator" if any(k.startswith("depth_estimator.") for k in sd) else ""
        tables.append((depth_entries(depth, prefix, "depth_net", context_bn=context_bn,
                                     dep_context=dep_context), prefix, "depth_estimator"))
    if pose is not None:
        if pose != "POSENET":
            raise KeyError(f"no weight table for pose estimator {pose}")
        tables.append((plainpose_entries("posenet", "pose_net"), "posenet", "posenet"))
    load, consumed, missing = {}, [], []
    for entries, prefix, module in tables:
        def take(key, required=True, bgr=False):
            key = key.lstrip(".")
            if key in sd:
                consumed.append(key)
                load[key if prefix else f"{module}.{key}"] = sd[key].flip(1) if bgr else sd[key]
            elif required:
                missing.append(key)

        for kind, tkey, _ in entries:
            if kind == "bn":
                for suffix in BN_SUFFIXES:
                    take(f"{tkey}.{suffix}")
            elif kind == "gn":
                continue
            elif kind == "conv2d_cat":
                for key in tkey:
                    take(f"{key}.weight")
                for key in tkey:
                    take(f"{key}.bias", required=False)
            elif kind == "conv2d_bgr":
                take(f"{tkey}.weight", bgr=True)
                take(f"{tkey}.bias", required=False)
            else:
                take(f"{tkey}.weight")
                take(f"{tkey}.bias", required=False)
    result = model.load_state_dict(load, strict=False)
    if result.unexpected_keys:
        raise KeyError(f"table keys the model lacks: {result.unexpected_keys[:5]}")
    return {"consumed": consumed, "missing": missing,
            "unused": sorted(set(sd) - set(consumed))}
