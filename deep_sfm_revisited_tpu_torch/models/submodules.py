"""Shared network blocks (port of `models/submodules.py`).

torch.nn modules named as the reference's `models/submodule.py` names them
(`convbn` = Sequential(Conv2d, BatchNorm2d), ...), so a reference state
dict loads with a plain `load_state_dict`. The blocks compute in NCHW /
NCDHW; the public models (`PSNet`, `DICLFlow`, `SFMNet`) take and return
the JAX package's NHWC. `resize_bilinear` keeps the JAX signature (NHWC).

The JAX package's `Conv3DMXU` (a TPU formulation of a 3D convolution as
depth-shifted 2D convolutions, optionally D-packed) is a plain `nn.Conv3d`
here; `depth.dpack > 1` is not supported by the port.

Batch normalization is `BatchNorm2d` / `BatchNorm3d` below: torch's modules
with flax's running-statistics update in train mode, and `checkpointed`
keeps a recomputed forward from updating them a second time.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def no_autocast(device: torch.device):
    """Geometry (projections, coordinates) always runs in float32."""
    return torch.autocast(device_type=device.type, enabled=False)


# > 0 while `checkpointed` recomputes a forward: train-mode BN then
# normalizes by its batch but leaves its running statistics alone
_frozen_stats = 0


class _FlaxStats:
    """Train-mode running statistics as flax updates them (`nn.BatchNorm(
    momentum=0.9)`, JAX `models/submodules.py:45-46`): running = 0.9 running
    + 0.1 batch, with the BIASED batch variance. Torch moves a running
    variance by the unbiased one, so the forward lets it move copies of the
    statistics and stores the biased update from them.
    Normalization and the eval forward are torch's own, but for a batch of
    one value per channel (a 1x1 map at batch 1), which torch refuses in
    train mode and flax normalizes to the bias (variance 0)."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        n = x.numel() // x.shape[1]
        if n == 1:
            return self._single(x)
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        if _frozen_stats:     # a recomputation saves what the first forward saved
            return y
        keep = 1.0 - self.momentum
        with torch.no_grad():
            # var = keep old + m var_unbiased, and var_biased = var_unbiased (n-1)/n
            old = self.running_var
            self.running_var.copy_((var - keep * old) * ((n - 1) / n) + keep * old)
            self.running_mean.copy_(mean)
            self.num_batches_tracked.add_(1)
        return y

    def _single(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean = x.mean(dim=[0, *range(2, x.dim())], keepdim=True)        # = x
        y = (x - mean) * (self.eps ** -0.5) * self.weight.view(shape) + self.bias.view(shape)
        if not _frozen_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean.reshape(-1).to(self.running_mean.dtype), self.momentum)
                self.running_var.mul_(1.0 - self.momentum)
                self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxStats, nn.BatchNorm3d):
    pass


def checkpointed(fn, *args):
    """`fn(*args)` under `torch.utils.checkpoint` (the JAX package's
    `nn.remat`): its activations are recomputed in the backward pass, and the
    recomputation updates no BN running statistics (flax's remat is
    functional, so JAX's run updates them once)."""
    calls = []

    def run(*a):
        global _frozen_stats
        calls.append(None)
        if len(calls) == 1:
            return fn(*a)
        _frozen_stats += 1
        try:
            return fn(*a)
        finally:
            _frozen_stats -= 1

    return checkpoint(run, *args, use_reentrant=False)


def convbn(cin: int, cout: int, kernel: int, stride: int, dilation: int) -> nn.Sequential:
    """Conv2d (bias-free) + BatchNorm2d, no activation (ref `convbn`)."""
    pad = dilation if dilation > 1 else kernel // 2
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, stride, pad, dilation=dilation, bias=False),
        BatchNorm2d(cout),
    )


def convbn_3d(cin: int, cout: int, kernel: int = 3) -> nn.Sequential:
    """Conv3d kernel^3 (bias-free, SAME) + BatchNorm3d (ref `convbn_3d`);
    PANet's residual blocks end in a 1x1x1 one."""
    return nn.Sequential(nn.Conv3d(cin, cout, kernel, 1, kernel // 2, bias=False),
                         BatchNorm3d(cout))


class BasicBlock(nn.Module):
    """Residual block without a final activation (ref `BasicBlock`)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Sequential(convbn(cin, cout, 3, stride, dilation), nn.ReLU())
        self.conv2 = convbn(cout, cout, 3, 1, dilation)
        self.downsample = (
            nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), BatchNorm2d(cout))
            if downsample else None
        )

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return out + x


def _resize_nchw(x: torch.Tensor, hw: Tuple[int, int], align_corners: bool = True):
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=align_corners)


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of NHWC (B, H, W, C), torch `F.interpolate` semantics
    (the JAX function builds the same map from interpolation matrices)."""
    return _resize_nchw(x.permute(0, 3, 1, 2), hw, align_corners).permute(0, 2, 3, 1)


class SPPFeatureExtractor(nn.Module):
    """SPP encoder at 1/4 resolution (ref `feature_extraction`).

    NCHW (B, 3, H, W) -> (B, 32, H/4, W/4). Pool branches (32, 16, 8, 4)
    are branch1..4, clamped to the map size as in the JAX module.
    """

    def __init__(self):
        super().__init__()
        self.firstconv = nn.Sequential(
            convbn(3, 32, 3, 2, 1), nn.ReLU(),
            convbn(32, 32, 3, 1, 1), nn.ReLU(),
            convbn(32, 32, 3, 1, 1), nn.ReLU(),
        )
        self.layer1 = self._layer(32, 32, 3, 1, 1)
        self.layer2 = self._layer(32, 64, 16, 2, 1)
        self.layer3 = self._layer(64, 128, 3, 1, 1)
        self.layer4 = self._layer(128, 128, 3, 1, 2)
        self.pools = (32, 16, 8, 4)
        for i in range(4):
            self.add_module(f"branch{i + 1}", nn.Sequential(
                nn.Identity(), convbn(128, 32, 1, 1, 1), nn.ReLU()))
        self.lastconv = nn.Sequential(
            convbn(320, 128, 3, 1, 1), nn.ReLU(), nn.Conv2d(128, 32, 1, bias=False))

    @staticmethod
    def _layer(cin, cout, blocks, stride, dilation):
        layers = [BasicBlock(cin, cout, stride, dilation,
                             downsample=(stride != 1 or cin != cout))]
        layers += [BasicBlock(cout, cout, 1, dilation) for _ in range(blocks - 1)]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.layer1(self.firstconv(x))
        raw = self.layer2(x)
        skip = self.layer4(self.layer3(raw))
        H, W = skip.shape[-2:]
        branches = []
        for i, pool in enumerate(self.pools):
            p = (min(pool, H), min(pool, W))
            b = getattr(self, f"branch{i + 1}")(F.avg_pool2d(skip, p, stride=p))
            branches.append(_resize_nchw(b, (H, W)))
        feat = torch.cat([raw, skip] + branches[::-1], dim=1)
        return self.lastconv(feat)


def soft_argmax_disparity(prob: torch.Tensor, maxdisp: int,
                          trunc_soft: bool = False) -> torch.Tensor:
    """Expected label 1..maxdisp of prob (B, D, H, W) -> (B, H, W); with
    `trunc_soft`, renormalized within +-maxdisp//2 of the argmax label."""
    disp = torch.arange(1, maxdisp + 1, dtype=prob.dtype, device=prob.device)
    disp = disp[None, :, None, None]
    if trunc_soft:
        idx = torch.argmax(prob, dim=1, keepdim=True)
        lab = torch.arange(maxdisp, device=prob.device)[None, :, None, None]
        window = (torch.abs(lab - idx) <= maxdisp // 2).to(prob.dtype)
        w = prob * window
        prob = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-12)
    return torch.sum(prob * disp, dim=1)


def soft_argmax_depth(prob: torch.Tensor, maxdisp: int, min_depth: float) -> torch.Tensor:
    """Expected metric depth over labels min_depth * (1..maxdisp)."""
    d = torch.arange(1, maxdisp + 1, dtype=prob.dtype, device=prob.device)
    return torch.sum(prob * (d * min_depth)[None, :, None, None], dim=1)
