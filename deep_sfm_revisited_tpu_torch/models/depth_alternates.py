"""PANet and REGNet, the pose-robust plane-sweep depth nets (port of
`deep_sfm_revisited_tpu/models/depth_alternates.py`), eval and train forward.

Both take the SFMNet depth contract of `models/psnet.py::PSNet` (NHWC images
in [-1, 1], targets (B, T, H, W, 3), poses (B, T, 3, 4) ref->target, K) and
return (depth_init, depth):

- `PANet` (JAX `:167-219`): the [ref | warped] cost volume of PSNet under
  `pose_scales` scaled copies of the pose (`sample_pose_by_scale`), the scales
  folded into the batch of ONE `ops/camera.py::plane_sweep_volume` call (B1's
  sweep kernel on the card), each scale regularized by a small shared 3D
  hourglass (`dres00`-`dres03`, `classify0`), the max over scales
  (`torch.amax`, which splits a gradient evenly among ties as `jnp.max` does),
  the 2D context stack `convs`, soft-argmax. It returns (None, depth), as JAX
  does, so it cannot train: JAX's trainer feeds `depth_init` to the loss,
  which fails on None (`train/trainer.py` refuses it before a step).
- `REGNet` (JAX `:222-282`): the correlation mean(ref * warped, -1) over the
  planes and `sample_pose_grid`'s n^3 coupled pose perturbations
  (`ops/camera.py::sweep_correlation`: kernel K1 on the card, its backward
  K2), treated as an (n^3, D, H, W) volume, a leaky ReLU, the 3D stack
  `posecnn0`-`posecnn4` + `predict`, the context stack `convs`; it returns
  both depths and trains.

Module names follow the reference (`models/PANet.py`, `models/REGNet.py`)
through the JAX package's weight tables (`utils/weights.py::panet_entries`,
`regnet_entries`). As in the JAX modules, the features are warped in float32
(float64 features are cast; bfloat16 ones are read exactly) and the
regression runs in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deep_sfm_revisited_tpu_torch.config import DepthConfig
from deep_sfm_revisited_tpu_torch.models.psnet import context_stack
from deep_sfm_revisited_tpu_torch.models.submodules import (
    SPPFeatureExtractor,
    _resize_nchw,
    convbn_3d,
    no_autocast,
    soft_argmax_disparity,
)
from deep_sfm_revisited_tpu_torch.ops.camera import plane_sweep_volume, sweep_correlation
from deep_sfm_revisited_tpu_torch.ops.rotations import angle_to_matrix, matrix_to_angle


def pose_scales(cfg: DepthConfig) -> np.ndarray:
    """PANet's pose scales (JAX `:55-56`): 9 with the config's defaults."""
    return np.arange(cfg.scale_min, cfg.scale_max, cfg.scale_step)


def sample_pose_by_scale(pose: torch.Tensor, scales: torch.Tensor,
                         full_translation: bool = False) -> torch.Tensor:
    """Scale hypotheses of a (B, 3, 4) pose -> (B, S, 3, 4) (JAX `:59-82`):
    the Euler angles and the z-translation scaled; with `full_translation`
    the whole translation (REG2D's variant)."""
    B, S = pose.shape[0], scales.shape[0]
    ang = matrix_to_angle(pose[:, :3, :3])                      # (B, 3)
    R = angle_to_matrix(ang[:, None] * scales[None, :, None])   # (B, S, 3, 3)
    t = pose[:, None, :3, 3].expand(B, S, 3)
    if full_translation:
        t = t * scales[None, :, None]
    else:
        t = torch.cat([t[..., :2], t[..., 2:] * scales[None, :, None]], dim=-1)
    return torch.cat([R, t[..., None]], dim=-1)


def sample_pose_grid(pose: torch.Tensor, sample_num: int, std_rot: float,
                     std_tr: float) -> torch.Tensor:
    """REGNet's coupled pose-perturbation grid (JAX `:121-144`): (B, 3, 4) ->
    (B, n^3, 3, 4); grid point (i, j, k) perturbs the Euler angles by
    (g_i, g_j, g_k) std_rot (the delta rotation composed on the left) and the
    translation by (g_i, g_j, g_k) std_tr, g spanning [-1, 1]."""
    n = sample_num
    base = torch.arange(-(n // 2), n // 2 + 1, dtype=torch.float32, device=pose.device)
    g = -base / base[0]
    grid = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1).reshape(n ** 3, 3)
    dR = angle_to_matrix(grid * std_rot)                        # (S, 3, 3)
    R = torch.einsum("sij,bjk->bsik", dR, pose[:, :3, :3])
    t = pose[:, None, :3, 3] + (grid * std_tr)[None]            # (B, S, 3)
    return torch.cat([R, t[..., None]], dim=-1)


def quarter_K(K: torch.Tensor):
    """K at the features' quarter scale, float32, and its inverse (JAX `:85-88`)."""
    scale = torch.tensor([0.25, 0.25, 1.0], device=K.device)
    K4 = K.float() * scale[None, :, None]
    return K4, torch.linalg.inv(K4)


def upsample_regress(cost: torch.Tensor, nlabel: int, min_depth: float, H: int,
                     W: int) -> torch.Tensor:
    """(B, D, h, w) costs -> (B, H, W) depth (JAX `_upsample_regress`,
    `:110-118`): half-pixel bilinear upsample, softmax over D and the plain
    inverse-depth soft-argmax, in float32. Unlike PSNet's `_regress` it
    ignores `trunc_soft` and `predict_by_depth`, as JAX's does."""
    prob = torch.softmax(_resize_nchw(cost.float(), (H, W), align_corners=False), dim=1)
    return min_depth * nlabel / (soft_argmax_disparity(prob, nlabel) + 1e-16)


def _sweep_dtype(feat: torch.Tensor) -> torch.dtype:
    """The JAX modules warp `feat.astype(float32)`: bfloat16 is read exactly
    by the kernels, float64 is cast."""
    return torch.float32 if feat.dtype == torch.float64 else feat.dtype


class _PoseSweepNet(nn.Module):
    """What PANet and REGNet share: the SPP features, the plane depths and
    the context stack over the planes."""

    def __init__(self, cfg: DepthConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extraction = SPPFeatureExtractor()

    def _features(self, ref, targets):
        """NHWC ref (B, H, W, 3), targets (B, T, H, W, 3) -> (ref, [tgt per
        target]) NCHW. In train mode one extractor call per image (BN batch
        statistics per call, as the JAX modules call it); in eval one call for
        all (BN uses running statistics)."""
        B, T = ref.shape[0], targets.shape[1]
        if self.training:
            return (self.feature_extraction(ref.permute(0, 3, 1, 2)),
                    [self.feature_extraction(targets[:, j].permute(0, 3, 1, 2))
                     for j in range(T)])
        imgs = torch.cat([ref] + [targets[:, j] for j in range(T)], dim=0)
        feats = self.feature_extraction(imgs.permute(0, 3, 1, 2))
        return feats[:B], [feats[B * (1 + j):B * (2 + j)] for j in range(T)]

    def _geometry(self, K, device):
        cfg = self.cfg
        with no_autocast(device):
            K4, K4_inv = quarter_K(K)
            labels = torch.arange(1, cfg.nlabel + 1, dtype=torch.float32, device=device)
            return K4, K4_inv, cfg.min_depth * cfg.nlabel / labels   # far -> near

    def _context(self, ref_feat, costs):
        """costs (B, D, h, w) + the context stack over [ref | cost] per plane."""
        B, C, h, w = ref_feat.shape
        D = costs.shape[1]
        ctx_in = torch.cat([ref_feat[:, None].expand(B, D, C, h, w),
                            costs[:, :, None].to(ref_feat.dtype)], dim=2)
        return self.convs(ctx_in.reshape(B * D, C + 1, h, w)).reshape(B, D, h, w) + costs


class PANet(_PoseSweepNet):
    """Pose-aware plane sweep: PSNet's volume under scaled poses, a shared
    small hourglass, the max over scales (JAX `PANet`, `SmallHourglass3D`)."""

    def __init__(self, cfg: DepthConfig):
        super().__init__(cfg)
        # JAX SmallHourglass3D under the reference's names
        self.dres00 = nn.Sequential(convbn_3d(64, 8), nn.ReLU(), convbn_3d(8, 16), nn.ReLU())
        for i in range(1, 4):
            self.add_module(f"dres0{i}", nn.Sequential(
                convbn_3d(16, 16), nn.ReLU(), convbn_3d(16, 16, kernel=1)))
        self.classify0 = nn.Sequential(
            convbn_3d(16, 8), nn.ReLU(), nn.Conv3d(8, 1, 3, 1, 1, bias=False))
        self.convs = context_stack(33, cfg.context_bn)

    def _hourglass(self, cost: torch.Tensor) -> torch.Tensor:
        """(N, 64, D, h, w) -> (N, D, h, w)."""
        c0 = self.dres00(cost)
        for i in range(1, 4):
            c0 = c0 + getattr(self, f"dres0{i}")(c0)
        return self.classify0(c0)[:, 0]

    def forward(self, ref, targets, pose, K, K_inv=None):
        """ref (B, H, W, 3); targets (B, T, H, W, 3); pose (B, T, 3, 4); K
        (B, 3, 3). Returns (None, depth (B, H, W) float32), as JAX's PANet.
        `K_inv` is unused (the net rescales K)."""
        cfg = self.cfg
        B, H, W, _ = ref.shape
        T, dev = targets.shape[1], ref.device
        K4, K4_inv, depths = self._geometry(K, dev)
        scales = torch.as_tensor(pose_scales(cfg), dtype=torch.float32, device=dev)
        S = scales.shape[0]
        ref_feat, tgt_feats = self._features(ref, targets)
        dt = _sweep_dtype(ref_feat)
        ref_s = ref_feat.permute(0, 2, 3, 1).to(dt).repeat_interleave(S, dim=0).contiguous()
        costs = None
        for j in range(T):
            tgt_s = tgt_feats[j].permute(0, 2, 3, 1).to(dt).repeat_interleave(S, dim=0)
            with no_autocast(dev):
                poses = sample_pose_by_scale(pose[:, j].float(), scales)      # (B, S, 3, 4)
                # all scales in one sweep: (B S, D, h, w, 2C) [ref | warped]
                vol = plane_sweep_volume(ref_s, tgt_s.contiguous(), depths,
                                         poses.reshape(B * S, 3, 4),
                                         K4.repeat_interleave(S, dim=0),
                                         K4_inv.repeat_interleave(S, dim=0))
            c = self._hourglass(vol.to(ref_feat.dtype).permute(0, 4, 1, 2, 3))
            c = torch.amax(c.reshape(B, S, *c.shape[1:]), dim=1)           # over the scales
            costs = c if costs is None else costs + c
        costs = costs / T
        depth = upsample_regress(self._context(ref_feat, costs), cfg.nlabel, cfg.min_depth, H, W)
        return None, depth


class REGNet(_PoseSweepNet):
    """Correlation cost over planes x pose perturbations, regularized by 3D
    convolutions with the perturbations as channels (JAX `REGNet`)."""

    def __init__(self, cfg: DepthConfig):
        super().__init__(cfg)
        S = cfg.regnet_sample_num ** 3
        self.posecnn0 = nn.Sequential(convbn_3d(S, 32), nn.ReLU(), convbn_3d(32, 32), nn.ReLU())
        for i in range(1, 5):
            self.add_module(f"posecnn{i}", nn.Sequential(
                convbn_3d(32, 32), nn.ReLU(), convbn_3d(32, 32)))
        self.predict = nn.Sequential(
            convbn_3d(32, 32), nn.ReLU(), nn.Conv3d(32, 1, 3, 1, 1, bias=False))
        self.convs = context_stack(33, cfg.context_bn)

    def forward(self, ref, targets, pose, K, K_inv=None):
        """ref (B, H, W, 3); targets (B, T, H, W, 3); pose (B, T, 3, 4); K
        (B, 3, 3). Returns (depth_init, depth), each (B, H, W) float32:
        without and with the context stack. `K_inv` is unused."""
        cfg = self.cfg
        B, H, W, _ = ref.shape
        T, dev = targets.shape[1], ref.device
        K4, K4_inv, depths = self._geometry(K, dev)
        ref_feat, tgt_feats = self._features(ref, targets)
        dt = _sweep_dtype(ref_feat)
        ref_nhwc = ref_feat.permute(0, 2, 3, 1).to(dt).contiguous()
        costs = None
        for j in range(T):
            tgt = tgt_feats[j].permute(0, 2, 3, 1).to(dt).contiguous()
            with no_autocast(dev):
                poses = sample_pose_grid(pose[:, j].float(), cfg.regnet_sample_num,
                                         cfg.regnet_std_rot, cfg.regnet_std_tr)
                # (B, n^3, D, h, w) float32, channels-last-3d: the poses are channels
                corr = sweep_correlation(ref_nhwc, tgt, depths, poses, K4, K4_inv)
            cost = F.leaky_relu(corr, 0.1).to(ref_feat.dtype)
            c0 = self.posecnn0(cost)
            for i in range(1, 5):
                c0 = c0 + getattr(self, f"posecnn{i}")(c0)
            c = self.predict(c0)[:, 0]
            costs = c if costs is None else costs + c
        costs = costs / T
        costss = self._context(ref_feat, costs)
        return (upsample_regress(costs, cfg.nlabel, cfg.min_depth, H, W),
                upsample_regress(costss, cfg.nlabel, cfg.min_depth, H, W))
