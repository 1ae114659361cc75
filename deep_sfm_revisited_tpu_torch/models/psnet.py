"""PSNet plane-sweep depth (port of `models/psnet.py`), eval and train forward.

SPP features at 1/4 resolution -> a (B, 64, D, H/4, W/4) cost volume of
[ref | warped target] features over D fronto-parallel planes -> the 3D
hourglass `dres0-4` + `classify` -> per-plane 2D context refinement ->
bilinear upsample, softmax, soft-argmax -> the depth-domain context head.

The cost volume comes whole from `ops/camera.py::plane_sweep_volume`, so on
the GPU one launch of kernel B1's sweep entry builds it per target, in the
(B, D, h4, w4, 2C) layout whose NCDHW view has channels-last-3d strides (the
layout cuDNN's 3D convolutions read natively). Where the features need a
gradient (train mode), the volume's backward is the sweep backward kernel.
Module names follow the reference (`models/PSNet.py`), so its checkpoints load
with `load_state_dict`.

In train mode, as in the JAX module, the SPP extractor runs once for the
reference and once per target (BN batch statistics per call, JAX
`psnet.py:187-200`), and with `depth.remat` the hourglass and the context net
run under `torch.utils.checkpoint` (JAX `nn.remat`, `:207-215,280`).
"""

from __future__ import annotations

import torch
from torch import nn

from deep_sfm_revisited_tpu_torch.config import DepthConfig
from deep_sfm_revisited_tpu_torch.models.submodules import (
    BatchNorm2d,
    SPPFeatureExtractor,
    _resize_nchw,
    checkpointed,
    convbn_3d,
    no_autocast,
    soft_argmax_depth,
    soft_argmax_disparity,
)
from deep_sfm_revisited_tpu_torch.ops.camera import plane_sweep_volume

# (out channels, dilation) of the reference's `convtext` stacks: every
# layer is a bias-free 3x3 conv ending in ReLU, the last one included
_CONTEXT_PLAN = [(128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1), (1, 1)]


def context_stack(cin: int, use_bn: bool) -> nn.Sequential:
    """`convs` / `dep_convs` (ref PSNet.py:54-72): 7 convtext layers."""
    layers = []
    for cout, dil in _CONTEXT_PLAN:
        block = [nn.Conv2d(cin, cout, 3, 1, dil, dilation=dil, bias=False)]
        if use_bn:
            block.append(BatchNorm2d(cout))
        block.append(nn.ReLU())
        layers.append(nn.Sequential(*block))
        cin = cout
    return nn.Sequential(*layers)


class PSNet(nn.Module):
    """Plane-sweep depth network; inputs NHWC images in [-1, 1]."""

    def __init__(self, cfg: DepthConfig, norm_target: float = 0.0):
        super().__init__()
        G = cfg.dpack if cfg.dpack > 1 and cfg.nlabel % cfg.dpack == 0 else 1
        if G > 1:
            raise NotImplementedError("depth.dpack > 1 (a TPU layout) is not ported")
        self.cfg = cfg
        self.norm_target = norm_target
        self.feature_extraction = SPPFeatureExtractor()
        # the JAX Hourglass3D, under the reference's names (dres0-4, classify)
        self.dres0 = nn.Sequential(convbn_3d(64, 32), nn.ReLU(), convbn_3d(32, 32), nn.ReLU())
        for i in range(1, 5):
            self.add_module(f"dres{i}", nn.Sequential(
                convbn_3d(32, 32), nn.ReLU(), convbn_3d(32, 32)))
        self.classify = nn.Sequential(
            convbn_3d(32, 32), nn.ReLU(), nn.Conv3d(32, 1, 3, 1, 1, bias=False))
        if cfg.psnet_context:
            self.convs = context_stack(33, cfg.context_bn)
        if cfg.psnet_dep_context:
            self.dep_convs = context_stack(36, cfg.context_bn)

    def _hourglass(self, cost: torch.Tensor) -> torch.Tensor:
        """(B, 64, D, h4, w4) -> (B, D, h4, w4) (ref PSNet.py:160-165)."""
        c0 = self.dres0(cost)
        for i in range(1, 5):
            c0 = getattr(self, f"dres{i}")(c0) + c0
        return self.classify(c0)[:, 0]

    def _regress(self, vol: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """(B, D, h4, w4) costs -> (B, H, W) depth: half-pixel bilinear
        upsample (the reference's trilinear without align_corners), softmax
        over D, soft-argmax."""
        cfg = self.cfg
        v = _resize_nchw(vol.float(), (H, W), align_corners=False)
        prob = torch.softmax(v, dim=1)
        if cfg.predict_by_depth:
            return soft_argmax_depth(prob, cfg.nlabel, cfg.min_depth)
        disp = soft_argmax_disparity(prob, cfg.nlabel, trunc_soft=cfg.trunc_soft)
        return cfg.min_depth * cfg.nlabel / (disp + 1e-16)

    def forward(self, ref, targets, pose, K, K_inv=None):
        """ref (B, H, W, 3); targets (B, T, H, W, 3); pose (B, T, 3, 4)
        ref->target; K (B, 3, 3). Returns (depth_init, depth), each (B, H, W)
        float32 -- (pre-context, refined) with the depth context head on,
        as the JAX module returns, in train mode as in eval. `K_inv` is
        unused (PSNet rescales K)."""
        cfg = self.cfg
        B, H, W, _ = ref.shape
        T = targets.shape[1]
        nlabel = cfg.nlabel
        dev = ref.device
        with no_autocast(dev):
            scale = torch.tensor([0.25, 0.25, 1.0], device=dev)
            K4 = K.to(torch.promote_types(ref.dtype, torch.float32)) * scale[None, :, None]
            K4_inv = torch.linalg.inv(K4)
            pose = pose.float()
            if self.norm_target > 0:
                pose = torch.cat([pose[..., :3], pose[..., 3:] * self.norm_target], dim=-1)
            labels = torch.arange(1, nlabel + 1, dtype=torch.float32, device=dev)
            plane_depths = cfg.min_depth * nlabel / labels   # far -> near

        if self.training:
            # one extractor call per image: BN batch statistics per call
            ref_feat = self.feature_extraction(ref.permute(0, 3, 1, 2))
            tgt_feats = [self.feature_extraction(targets[:, j].permute(0, 3, 1, 2))
                         for j in range(T)]
        else:
            # one extractor call for ref + targets (BN uses running stats)
            imgs = torch.cat([ref] + [targets[:, j] for j in range(T)], dim=0)
            feats = self.feature_extraction(imgs.permute(0, 3, 1, 2))
            ref_feat = feats[:B]                              # (B, 32, h4, w4)
            tgt_feats = [feats[B * (1 + j):B * (2 + j)] for j in range(T)]
        C, h4, w4 = ref_feat.shape[1:]
        ref_nhwc = ref_feat.permute(0, 2, 3, 1).contiguous()

        remat = cfg.remat and torch.is_grad_enabled()

        def run(fn, x):
            return checkpointed(fn, x) if remat else fn(x)

        costs = None
        for j in range(T):
            tgt = tgt_feats[j].permute(0, 2, 3, 1).contiguous()
            with no_autocast(dev):
                vol = plane_sweep_volume(ref_nhwc, tgt, plane_depths, pose[:, j], K4, K4_inv)
            # (B, D, h4, w4, 2C) [ref | warped] -> its (B, 2C, D, h4, w4) view
            c = run(self._hourglass, vol.permute(0, 4, 1, 2, 3))   # (B, D, h4, w4)
            costs = c if costs is None else costs + c
        costs = costs / T

        if cfg.psnet_context:
            ctx_in = torch.cat([ref_feat[:, None].expand(B, nlabel, C, h4, w4),
                                costs[:, :, None]], dim=2)   # (B, D, 33, h4, w4)
            ctx = run(self.convs, ctx_in.reshape(B * nlabel, C + 1, h4, w4))
            costss = ctx.reshape(B, nlabel, h4, w4) + costs
        else:
            costss = costs

        depth_init = self._regress(costs, H, W)
        depth = self._regress(costss, H, W)
        if cfg.psnet_dep_context:
            up_feat = _resize_nchw(ref_feat, (H, W))
            # no gradient through the depth fed to the head (JAX stop_gradient)
            dep_in = torch.cat([depth.detach()[:, None].to(up_feat.dtype), up_feat,
                                ref.permute(0, 3, 1, 2).to(up_feat.dtype)], dim=1)
            depth_out = self.dep_convs(dep_in)[:, 0].float() + depth
            return depth, depth_out
        return depth_init, depth
