"""Typed configuration system (the PyTorch port's own copy).

A verbatim copy of `deep_sfm_revisited_tpu/config.py`, kept here so the
port never imports the JAX package (whose `__init__` imports jax). The
two files must stay field-for-field identical; `tests/test_torch_camera.py`
checks that. Knobs that only shape the TPU program (`depth.warp_kernel`,
`mesh.*`, and the train loop's `chain_steps`) are accepted and ignored by
the port; `depth.remat` becomes `torch.utils.checkpoint` in training.

Original notes: TPU-native replacement for the reference's module-global EasyDict config
(`lib/config.py:5-6` with ~200 flags at `lib/config.py:15-370`, YAML merge
`cfg_from_file` `lib/config.py:380`, list override `cfg_from_list`
`lib/config.py:419`, dump `save_config_to_file` `lib/config.py:441`).

Design differences (deliberate):
  * frozen dataclasses instead of ambient global state — configs are passed
    explicitly and are hashable, so they can be `jax.jit` static arguments;
  * the same strict key + type validation the reference applies when merging
    YAML (`lib/config.py:397-407`);
  * grouped by subsystem rather than one flat namespace, with a flat
    dotted-key override syntax covering both.

The shipped `cfgs/kitti.yml` of the reference is reproduced as
`SfMConfig.kitti()` so the headline recipe is importable without files.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, replace
from typing import Any, Tuple


def _tuplify(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tuplify(v) for v in x)
    return x


@dataclass(frozen=True)
class FlowConfig:
    """Flow-estimator knobs (reference: `lib/config.py:178,216-370`)."""

    estimator: str = "RAFT"  # RAFT | DICL | PWC  (ref FLOW_EST, default DICL)
    # RAFT (models/RAFT/core/raft.py:30)
    raft_iters_train: int = 12
    raft_iters_eval: int = 24
    raft_hidden_dim: int = 128
    raft_context_dim: int = 128
    raft_corr_levels: int = 4
    raft_corr_radius: int = 4
    # DICL (models/DICL_shallow.py; cfgs/kitti.yml:54-76)
    dicl_search_range: Tuple[int, ...] = (3, 3, 3, 3, 3)  # ref SEATCH_RANGE (sic)
    dicl_ctf: bool = True                 # coarse-to-fine warping, ref CTF
    dicl_ctf_context: bool = True         # per-level context nets, ref CTF_CONTEXT
    dicl_smooth_cost: bool = True         # learned 1x1 cost smoothing, ref SMOOTH_COST
    dicl_sup_raw_flow: bool = True        # supervise pre-context flow, ref SUP_RAW_FLOW
    # fine->coarse (levels 2..6): the FINEST level gets the LARGEST context
    # scale (ref kitti.yml:69-73, SCALE_CONTEXT2=0.5 .. SCALE_CONTEXT6=0.03125)
    dicl_scale_context: Tuple[float, ...] = (0.5, 0.25, 0.125, 0.0625, 0.03125)
    dicl_flow_reg_by_max: bool = True     # soft-argmax window around argmax
    # windowed (truncated) soft-argmax: mask the cost to a ±size square
    # around the argmax displacement pre-softmax (ref TRUNCATED /
    # TRUNCATED_SIZE, lib/config.py:298-299, DICL_shallow.py:277-316)
    dicl_truncated: bool = False
    dicl_truncated_size: int = 3


@dataclass(frozen=True)
class DepthConfig:
    """Plane-sweep depth knobs (reference: `lib/config.py:24-100,181`)."""

    estimator: str = "PSNET"  # PSNET | PANET | REGNET | REG2D | DISPNET | CVP
    nlabel: int = 64          # depth planes; 128 for the KITTI recipe (README.md:52)
    min_depth: float = 1.0    # ref MIN_DEPTH (cfgs/kitti.yml)
    psnet_context: bool = True        # 2D context refinement, ref PSNET_CONTEXT
    trunc_soft: bool = False          # windowed (±nlabel//2 around argmax,
                                      # renormalized) soft-argmax regression
                                      # (ref TRUNC_SOFT, lib/config.py:77;
                                      # see soft_argmax_disparity for why the
                                      # literal reference form is unusable)
    psnet_dep_context: bool = True    # depth-domain context head, ref PSNET_DEP_CONTEXT
    context_bn: bool = False          # BN in context convs, ref CONTEXT_BN
    predict_by_depth: bool = False    # regress depth rather than inverse depth
    remat: bool = True                # jax.checkpoint the 3D cost stacks
                                      # (trade FLOPs for HBM at b=32; no-op
                                      # at inference — no backward pass)
    dpack: int = 1                    # D-packed hourglass: fold G planes
                                      # into channels so Cout=32 convs fill
                                      # all 128 MXU lanes ((G+2)/3 = 2x
                                      # FLOPs for 4x lane use). Measured
                                      # on v5e (vs 53 ms unpacked): halo
                                      # 60 ms, tridiag 52 ms (noise) — the
                                      # packed conv only reaches ~42-45% of
                                      # peak (scratch/conv_micro.py), so
                                      # OFF by default; auto-off unless
                                      # G | nlabel
    dpack_mode: str = "tridiag"       # tridiag: dense in-block core + two
                                      # small cross-block convs (G/3 = 1.33x
                                      # FLOPs); halo: one (G+2)/3 = 2x conv
    warp_kernel: bool = False         # Mosaic VMEM-resident plane-sweep
                                      # warp (ops/pallas/sweep_warp.py);
                                      # TPU-only — other backends fall
                                      # back to the XLA quad-gather.
                                      # BLOCKED on the current toolchain:
                                      # tpu.dynamic_gather spans only one
                                      # 128-lane vreg (see the module
                                      # docstring); leave False until a
                                      # Mosaic update lands
    # pose-scale sampling (PANet; ref lib/config.py:184-188)
    scale_min: float = 0.9
    scale_max: float = 1.1
    scale_step: float = 0.025
    # REGNet coupled pose-perturbation grid (ref REGNet.py:40-72,79):
    # sample_num^3 poses, Euler-angle and translation offsets indexed by
    # the same grid point
    regnet_sample_num: int = 5
    regnet_std_rot: float = 0.12
    regnet_std_tr: float = 0.27


@dataclass(frozen=True)
class PoseConfig:
    """Pose-estimation knobs (reference: `lib/config.py:51-55,198-214`)."""

    estimator: str = "RANSAC"  # RANSAC | POSENET | GT
    posenet_type: str = "plain"  # plain | res (models/PoseNet.py)
    # RANSAC (essential_matrix.cu:121-123 launches 8x64=512 workers x ransac_iter
    # rounds; we express the same budget as one flat hypothesis axis).
    num_hypotheses: int = 512
    ransac_iter: int = 5               # ref cfg.ransac_iter (kitti.yml)
    ransac_threshold: float = 1e-4     # Sampson inlier threshold (lib/config.py:54)
    min_matches: int = 20              # lib/config.py:55
    num_correspondences: int = 1024    # on-device flow-subsample count (replaces SIFT)
    corr_margin: int = 10              # image-border margin (models/SFMnet.py:183)
    # correspondence-sampling weight (replaces the SIFT/SURF keypoint
    # masks, models/SFMnet.py:203-254): "entropy" = flow-net confidence
    # (DICL FlowEntropy; the shipped default — wins the round-5 A/B on
    # adversarial golden scenes), "texture" = Shi-Tomasi image texture
    # score (ops/flow_ops.texture_pseudo_entropy — the closest analogue
    # of the reference's keypointed path), "uniform" = the reference's
    # dense-grid fallback as the primary
    sampler: str = "entropy"
    # two-stage Sampson scoring, the batched analogue of the reference's
    # per-worker pre-filter (score on c_num_test_points, full rescore only
    # when promising, kernel_functions.cu:187-214): stage 1 scores all
    # candidates on `score_subset` strided points, stage 2 rescores the
    # `score_topk` best on all points. The full (C, N) Sampson sweep is
    # HBM-bandwidth-bound, so this is ~1.5 ms/pair at the product protocol
    # (5.95 -> 4.42 ms ransac_pose, scratch/ransac_two_stage_probe.py)
    # with the IDENTICAL winner on every scene of the 16-seed study
    # (scratch/ransac_two_stage_accuracy.py). Self-disables to the exact
    # single-stage path whenever the budget is small (topk >= candidates
    # or subset >= points). 0 disables explicitly.
    score_subset: int = 128
    score_topk: int = 512
    polish_iters: int = 10             # IRLS robust polish rounds (polish_E.cu:1470)
    polish_huber_delta: float = 1e-3   # ref SFMnet delta=0.001 (models/SFMnet.py:36)
    use_polish: bool = True
    solve_dtype: str = "float32"       # five-point candidate pipeline dtype:
                                       # candidates only need to WIN the
                                       # Sampson vote — the f64 polish
                                       # restores precision; f32==f64 final
                                       # accuracy on synthetic scenes at
                                       # every noise/outlier level
                                       # (scratch/f32_solve_study.py), and
                                       # emulated f64 is ~10x per op on TPU.
                                       # "float64" = full-precision solve.
    # differentiable pose: refine E with implicit-function gradients so
    # pose error can train the flow net end-to-end (the reference defines
    # this machinery but never wires it, epipolar_utils.py:158-357)
    differentiable: bool = False
    gt_pose_normalized: bool = False   # ref GT_POSE_NORMALIZED
    pred_pose_gt_scale: bool = False   # oracle: rescale trans to GT norm


@dataclass(frozen=True)
class DataConfig:
    """Dataset + augmentation knobs (reference: `lib/config.py:15-45,190-196`)."""

    dataset: str = "kitti_raw"       # kitti_raw | kitti_vo
    train_size: Tuple[int, int] = (256, 768)   # cfgs/kitti.yml TRAIN_SIZE
    val_size: Tuple[int, int] = (370, 1224)    # lib/config.py:25
    skip: int = 1                    # frame-pair offset, ref SKIP
    zoom_input: bool = True          # random zoom 1.0-1.15 (flow_transforms.py:89-98)
    flip_aug: bool = True            # ref FLIP_AUG
    random_fw_bw: bool = True        # random forward/backward pair flip
    random_offset: bool = True       # random -1/-2 pair offset
    kitti_697: bool = True           # Eigen 697-image split (KITTI_loader.py:283-301)
    eigen_sfm: bool = False
    filtered_pair: bool = True       # eval target frames from the curated
                                     # val_img1_list_*.npy in the dataset
                                     # root when present (ref FILTERED_PAIR,
                                     # lib/config.py:85, KITTI_loader.py:
                                     # 310-317,338-340)
    eval_protocol: str = "eigen"     # eigen | demon masking at validate
                                     # (ref DEMON_DATASET branch, main.py:565-566)
    pad_multiple: int = 128          # pad H,W to /128 (main.py:315-338)
    workers: int = 8


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + loss knobs (reference: `main.py:66-115,245,350-422`)."""

    batch_size: int = 32
    lr: float = 5e-4
    epochs: int = 12
    milestones: Tuple[int, ...] = (3, 8)   # cfgs/kitti.yml MILESTONES
    lr_decay: float = 0.5                  # MultiStepLR gamma (main.py:245)
    beta1: float = 0.9
    beta2: float = 0.999
    fix_flownet: bool = True               # freeze flow net (README.md:52)
    fix_depthnet: bool = False
    mixed_prec: bool = True                # bf16 compute policy (ref MIXED_PREC)
    depth_init_weight: float = 0.7         # loss weight on depth_init (main.py:387-389)
    rescale_depth: bool = True             # GT-scale rescaling path (main.py:357-384)
    rescale_depth_remask: bool = False     # recheck mask bounds against the
                                           # rescaled GT (ref RESCALE_DEPTH_REMASK,
                                           # lib/config.py:132, default False)
    min_train_scale: float = 0.2           # cfgs/kitti.yml
    max_train_scale: float = 2.0
    norm_target: float = 0.6               # trans-norm target (cfgs/kitti.yml)
    pose_rot_weight: float = 20.0          # PoseNet rot-loss x20 (main.py:396-408)
    seed: int = 0
    print_freq: int = 20
    # emit input / flow-RGB / pred- and GT-depth-colormap TensorBoard
    # image panes every `image_freq` steps (≙ main.py:429-447, which
    # emits every print period). 0 disables. The chained loops run one
    # extra inference forward per emission (their step programs keep no
    # image-sized outputs), so this is deliberately sparser than
    # print_freq by default — ~0.5% overhead at 100.
    image_freq: int = 100
    # steps fused into one compiled program per dispatch in the
    # production loops (train/loop.py). On the remote-TPU platform a
    # dispatch costs ~27 ms and a device->host read ~25 ms; chaining
    # amortizes both (ChainedStep / ChainedEval). 1 still accumulates
    # metrics on device, it just dispatches per step.
    chain_steps: int = 4
    eval_chain_steps: int = 8


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (no reference counterpart; SURVEY.md §2.7)."""

    data_axis: str = "data"
    model_axis: str = "model"   # shards RANSAC hypotheses / depth planes
    data_parallel: int = -1     # -1: all devices on the data axis
    model_parallel: int = 1


@dataclass(frozen=True)
class SfMConfig:
    """Top-level config. `tag` names the run (ref TAG, main.py:128-130)."""

    tag: str = "default"
    flow: FlowConfig = field(default_factory=FlowConfig)
    depth: DepthConfig = field(default_factory=DepthConfig)
    pose: PoseConfig = field(default_factory=PoseConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    use_gt_pose: bool = False        # ref GT_POSE
    pred_pose_online: bool = True    # ref PRED_POSE_ONLINE
    record_pose: bool = False        # early-return pose path (models/SFMnet.py:157-158)
    record_pose_eval: bool = False   # pose early-return at EVAL only
                                     # (ref RECORD_POSE_EVAL, lib/config.py:149)

    @staticmethod
    def kitti(nlabel: int = 128) -> "SfMConfig":
        """The shipped KITTI recipe (`cfgs/kitti.yml`, README.md:50-61)."""
        return SfMConfig(
            tag="kitti",
            # the reference recipe runs DICL flow (FLOW_EST default,
            # lib/config.py:178 — the released kitti.pth.tar weights)
            flow=replace(FlowConfig(), estimator="DICL"),
            # remat=False: at the recipe's per-chip b=1 shard the hourglass
            # activations fit HBM with slack and recomputation costs 16%
            # (239 -> 206 ms/step measured); the generic DepthConfig
            # default stays True for larger per-chip batches
            depth=replace(DepthConfig(), nlabel=nlabel,
                          psnet_dep_context=True, remat=False),
            train=replace(TrainConfig(), mixed_prec=True, rescale_depth=True),
        )

    def override(self, **dotted: Any) -> "SfMConfig":
        """Override with dotted keys, e.g. cfg.override(**{"pose.ransac_iter": 3}).

        Replaces `cfg_from_list` (`lib/config.py:419`) with the same strict
        unknown-key / type-mismatch errors (`lib/config.py:397-407`).
        """
        cfg = self
        for key, value in dotted.items():
            cfg = _set_dotted(cfg, key.split("."), value)
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _set_dotted(obj, parts, value):
    name = parts[0]
    valid = {f.name: f for f in fields(obj)}
    if name not in valid:
        raise KeyError(f"unknown config key {name!r} on {type(obj).__name__}")
    current = getattr(obj, name)
    if len(parts) > 1:
        return replace(obj, **{name: _set_dotted(current, parts[1:], value)})
    value = _tuplify(value)
    if current is not None and value is not None:
        if isinstance(current, bool) != isinstance(value, bool):
            raise TypeError(f"type mismatch for {name}: {type(current)} vs {type(value)}")
        if isinstance(current, (int, float)) and isinstance(value, (int, float)):
            value = type(current)(value)
        elif type(current) is not type(value):
            raise TypeError(f"type mismatch for {name}: {type(current)} vs {type(value)}")
    return replace(obj, **{name: value})


def config_from_yaml(path: str, base: SfMConfig | None = None) -> SfMConfig:
    """Load dotted-key YAML overrides onto a base config (ref `cfg_from_file`)."""
    import yaml

    with open(path) as f:
        overrides = yaml.safe_load(f) or {}
    cfg = base or SfMConfig()
    flat = {}

    def _flatten(prefix, d):
        for k, v in d.items():
            kk = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                _flatten(kk, v)
            else:
                flat[kk] = v

    _flatten("", overrides)
    return cfg.override(**flat)


def save_config(cfg: SfMConfig, path: str) -> str:
    """Dump the full effective config to a YAML file the driver wires at
    run start (≙ the reference's startup config dump, `main.py:140-142`
    + `save_config_to_file` `lib/config.py:441-455`). Returns the YAML
    text so callers can also log it. The written file round-trips:
    `config_from_yaml(path)` reproduces the config exactly
    (tests/test_driver_wiring.py)."""
    import yaml

    text = yaml.safe_dump(cfg.to_dict(), sort_keys=False)
    with open(path, "w") as f:
        f.write(text)
    return text
