"""SFMNet, the two-view SfM composite (port of `models/sfmnet.py`), eval and train.

DICL flow with entropy confidence, or PWC-DC or RAFT flow (no confidence,
so the sampler takes its uniform path) -> correspondence sampling -> five-point
RANSAC in float64 -> PSNet plane-sweep depth (or, with `depth.estimator`
PANET or REGNET, `models/depth_alternates.py`'s nets). Like
`SFMNet(cfg, dtype=jnp.bfloat16)` of the JAX package, `dtype=torch.bfloat16`
runs flow, PoseNet and depth under `torch.autocast(..., torch.bfloat16)`;
RANSAC runs outside autocast in float64 (the reference's
`autocast(enabled=False)` + `.double()` region, `models/SFMnet.py:265-270`).

Routes: online RANSAC with the entropy, texture (Shi-Tomasi score of the
ref image) or uniform sampler; PoseNet regression (`pose.estimator=
"POSENET"`, `PlainPose` fed the flow and DICL's entropy, its `rt` output
returned for the pose loss); `use_gt_pose`; and pre-saved poses
(`pred_pose_online=False`). `pose.estimator="GT"` builds no pose net, as
JAX's composite: it takes the last two routes and raises on an online
forward, as JAX's does. Everything else the JAX composite offers raises
NotImplementedError (ROADMAP.md lists what is still to port).

Train mode (`model.train()`, JAX `train=True`, `sfmnet.py:163-170`): the
flow net runs in train mode (BN batch statistics, its running statistics
updated) and returns its per-level stack `flow_all` and `flow =
flow_all[-1]`; RANSAC runs without gradient (JAX's stop_gradient); PoseNet
and PSNet run in train mode with autograd on, and PoseNet's pose reaches
PSNet's cost volume with its gradient (the plane sweep's pose gradient,
`ops/camera.py::PlaneSweepVolumeFn`). The recipe's step keeps the flow net
frozen (`train.fix_flownet`): it runs without gradient. With
`train.fix_flownet=False` DICL runs with autograd on, so its flow stack
(the flow loss of a batch that carries `flow_gt`, `train/trainer.py`) and,
on the POSENET route, PoseNet's flow and confidence inputs reach its
parameters, as in JAX; PWC-DC likewise (its flow stack; it gives no
confidence).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from deep_sfm_revisited_tpu_torch.config import SfMConfig
from deep_sfm_revisited_tpu_torch.models.depth_alternates import PANet, REGNet
from deep_sfm_revisited_tpu_torch.models.dicl import DICLFlow, SmoothCost
from deep_sfm_revisited_tpu_torch.models.posenet import PlainPose
from deep_sfm_revisited_tpu_torch.models.psnet import PSNet
from deep_sfm_revisited_tpu_torch.models.pwcnet import PWCDCNet
from deep_sfm_revisited_tpu_torch.models.raft import RAFT
from deep_sfm_revisited_tpu_torch.ops.essential import ransac_pose
from deep_sfm_revisited_tpu_torch.ops.flow_ops import (sample_correspondences,
                                                       texture_pseudo_entropy)
from deep_sfm_revisited_tpu_torch.ops.rotations import rt_to_pose
from deep_sfm_revisited_tpu_torch.utils.device import resolve_device


FLOW_NETS = {"DICL": DICLFlow, "PWC": PWCDCNet, "RAFT": RAFT}
DEPTH_NETS = ("PSNET", "PANET", "REGNET")


def _check_supported(cfg: SfMConfig) -> None:
    unsupported = {
        "flow.estimator": cfg.flow.estimator not in FLOW_NETS,
        "depth.estimator": cfg.depth.estimator not in DEPTH_NETS,
        "pose.estimator": cfg.pose.estimator not in ("RANSAC", "POSENET", "GT"),
        "pose.sampler": cfg.pose.sampler not in ("entropy", "texture", "uniform"),
        "pose.differentiable": cfg.pose.differentiable,
    }
    for key, bad in unsupported.items():
        if bad:
            raise NotImplementedError(f"{key} = {_get(cfg, key)!r} is not ported yet")


def _get(cfg, dotted):
    for part in dotted.split("."):
        cfg = getattr(cfg, part)
    return cfg


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: convolutions and deconvolutions (DICL, PWC-DC,
    RAFT, PSNet) ~ N(0, 1/fan_in) (flax's lecun scale), zero biases,
    BatchNorm at identity with running stats at their defaults, RAFT's
    affine instance norms (GroupNorm) left at identity, and the DICL cost
    smoothing at identity (SMOOTH_INIT_BY_ID)."""
    keep = {id(m.smooth_layer.conv) for m in module.modules() if isinstance(m, SmoothCost)}
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
                if id(m) in keep:
                    continue
                w = m.weight
                if isinstance(m, nn.ConvTranspose2d):   # (I, O, kh, kw)
                    fan_in = w.shape[0] * w[0, 0].numel()
                else:
                    fan_in = w[0].numel()
                w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.reset_parameters()


class SFMNet(nn.Module):
    """Composite model. Images NHWC in [-1, 1]; intrinsics (B, 3, 3).

    `device` defaults to "cuda" and raises when CUDA is absent (pass
    device="cpu" to run on the CPU). Weights are random from `seed`;
    `load_state_dict` takes a converted or reference checkpoint.
    """

    def __init__(self, cfg: SfMConfig, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        norm_target = cfg.train.norm_target if cfg.train.rescale_depth else 0.0
        self.flow_estimator = FLOW_NETS[cfg.flow.estimator](cfg.flow)
        if cfg.depth.estimator == "PSNET":
            self.depth_estimator = PSNet(cfg.depth, norm_target=norm_target)
        else:
            self.depth_estimator = {"PANET": PANet, "REGNET": REGNet}[cfg.depth.estimator](
                cfg.depth)
        if cfg.pose.estimator == "POSENET":
            self.posenet = PlainPose()
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(self.device)
        self.eval()

    def _autocast(self):
        return torch.autocast(device_type=self.device.type, dtype=self.dtype,
                              enabled=self.dtype != torch.float32)

    def forward(self, ref, target, K, pose_gt=None, pred_pose=None,
                use_gt_pose: bool = False,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        """Returns dict(flow, flow_all, pose, rt, depth_init, depth,
        inliers, num_matches), the keys of the JAX composite
        (`sfmnet.py:213-226`); `pose` is ref->target (B, 3, 4), `rt` PoseNet's
        raw (B, 6) output on the POSENET route (None elsewhere).

        `generator` drives the sampler jitter, the Gumbel draws and the
        RANSAC minimal samples (a fresh generator seeded 0 when None).
        `draws` injects them instead: {"jitter": (B, 4N, 2) in [-0.5, 0.5),
        "gumbel_u": (B, 4N) in [1e-12, 1), "sample_idx": (B, H, 5)}.
        """
        cfg = self.cfg
        if cfg.pose.estimator == "GT" and not use_gt_pose and cfg.pred_pose_online:
            raise NotImplementedError("pose.estimator = 'GT' estimates no pose online: it takes "
                                      "use_gt_pose=True or pred_pose_online=False")
        train, grad = self.training, torch.is_grad_enabled()
        rt = conf = None
        with torch.no_grad():
            K = K.float()
            K_inv = torch.linalg.inv(K)
            inliers = num_matches = flow_all = None
            online = not use_gt_pose and cfg.pred_pose_online
            if use_gt_pose:
                if pose_gt is None:
                    raise ValueError("use_gt_pose needs pose_gt")
                pose = pose_gt.float()
                if cfg.pose.gt_pose_normalized:
                    pose = torch.cat([pose[..., :3], pose[..., 3:] / torch.linalg.vector_norm(
                        pose[..., 3], dim=-1)[:, None, None]], dim=-1)
                flow = torch.zeros(ref.shape[:3] + (2,), device=ref.device)
            elif not cfg.pred_pose_online:
                if pred_pose is None:
                    raise ValueError("pred_pose_online=False needs a pred_pose input")
                pose = self._gt_scaled(pred_pose.float(), pose_gt)
                flow = torch.zeros(ref.shape[:3] + (2,), device=ref.device)
            else:
                train_flow = train and grad and not cfg.train.fix_flownet
                with torch.set_grad_enabled(train_flow), self._autocast():
                    pair = torch.cat([ref, target], dim=-1)
                    if train:
                        flow_all, conf = self.flow_estimator(pair, all_iters=True)
                        flow_all = flow_all.float()
                        flow = flow_all[-1]
                    else:
                        flow, conf = self.flow_estimator(pair)
                    flow = flow.float()
                if cfg.pose.estimator == "RANSAC":
                    conf_s = None    # the uniform grid
                    if cfg.pose.sampler == "entropy":
                        conf_s = conf
                    elif cfg.pose.sampler == "texture":
                        conf_s = texture_pseudo_entropy(ref)
                    pose, inliers, num_matches = self._pose_by_ransac(
                        flow, K_inv, conf_s, generator, draws or {})
                    pose = self._gt_scaled(pose, pose_gt)

        if online and cfg.pose.estimator == "POSENET":
            # the flow and its confidence are inputs; PoseNet's pose keeps
            # its gradient into the depth net (not stop-gradient)
            with torch.set_grad_enabled(train and grad), self._autocast():
                rt = self.posenet(flow, ref, target, conf)
            pose = self._gt_scaled(rt_to_pose(rt), pose_gt)

        if cfg.record_pose or (cfg.record_pose_eval and not train):
            return {"pose": pose, "flow": flow, "num_matches": num_matches}

        with torch.set_grad_enabled(train and grad), self._autocast():
            depth_init, depth = self.depth_estimator(
                ref, target[:, None], pose[:, None], K, K_inv)
        return {"flow": flow, "flow_all": flow_all, "pose": pose, "rt": rt,
                "depth_init": depth_init, "depth": depth, "inliers": inliers,
                "num_matches": num_matches}

    def _gt_scaled(self, pose, pose_gt):
        if self.cfg.pose.pred_pose_gt_scale and pose_gt is not None:
            scale = torch.linalg.vector_norm(pose_gt[:, :3, 3].float(), dim=-1)
            pose = torch.cat([pose[..., :3], pose[..., 3:] * scale[:, None, None]], dim=-1)
        return pose

    def _pose_by_ransac(self, flow, K_inv, conf, generator, draws):
        """Sampler + RANSAC in float64 (JAX `_pose_by_ransac`, `:228-301`)."""
        pc = self.cfg.pose
        if generator is None:
            generator = torch.Generator(device=flow.device).manual_seed(0)
        sampled = sample_correspondences(
            flow.double(), K_inv.double(), num_points=pc.num_correspondences,
            margin=pc.corr_margin, conf=None if conf is None else conf.double(),
            min_matches=pc.min_matches, jitter=draws.get("jitter"),
            gumbel_u=draws.get("gumbel_u"), generator=generator)
        x1, x2 = sampled[:2]
        num_matches = sampled[2] if conf is not None else None
        out = ransac_pose(
            x1, x2, num_hypotheses=pc.num_hypotheses, ransac_iter=pc.ransac_iter,
            threshold=pc.ransac_threshold, polish=pc.use_polish,
            polish_iters=pc.polish_iters, huber_delta=pc.polish_huber_delta,
            solve_dtype=getattr(torch, pc.solve_dtype), score_subset=pc.score_subset,
            score_topk=pc.score_topk, sample_idx=draws.get("sample_idx"),
            generator=generator)
        return out["P"].float(), out["inliers"], num_matches
