"""PWC-DC optical flow (port of `models/pwcnet.py`), eval and train.

A shared 6-level pyramid encoder (16/32/64/96/128/196 channels, stride 2
per level, leaky ReLU 0.1) -> per level 6..2: the md=4 windowed correlation
on float32 features of the reference features with the target features
warped by the scaled up-sampled flow (levels 5..2: `warped_correlation_nchw`,
one kernel a level on the GPU in the network's layout and dtype; level 6
has no flow: `local_correlation`, kernel B2), a DenseNet-connected decoder
and its flow head, and 4x4 stride-2
deconvolutions for the next level's up-flow and up-feature -> a dilated
context net refining the level-2 flow -> x20 at full resolution.

Module names are upstream PWC-Net's (`conv1a`..`conv6b`, `conv6_0`..
`conv2_4`, `predict_flow6..2`, `deconv6..3`, `upfeat6..3`, `dc_conv1..7`),
so a reference PWC state dict loads with `load_state_dict`. Where the JAX
network departs from upstream the port follows JAX: the leaky ReLU is
applied to the correlation at level 6 only (`pwcnet.py:133`).

Layouts: `PWCDCNet.forward` takes (B, H, W, 6) NHWC, H and W multiples of
64, and returns (flow (B, H, W, 2) float32, None), like the port's DICL, or
with `all_iters` JAX's (5, B, H, W, 2) stack of every level's flow; inside,
features are NCHW.

Train mode: PWC-DC has no BN and no dropout, so train and eval compute the
same thing. The frozen-flow training step (`train.fix_flownet`) runs it in
train mode under no gradient; flow pretraining (`--train-flow`) and the
composite step with `train.fix_flownet=False` train it through the
`all_iters` stack. Both correlations are autograd functions
(`ops/correlation.py`): on the GPU their backward is a kernel too
(`csrc/warped_corr_backward.cu`), and the gradient reaches the up-sampled
flow through the warp, which PWC-DC does not detach (JAX
`pwcnet.py:125-131`).

Sizes: H and W must be multiples of 64, or a level's up-sampled flow and
its features differ by a row or a column. JAX raises there too (a
TypeError of its warp's broadcast); the port raises a ValueError naming
the rule (`check_size`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deep_sfm_revisited_tpu_torch.config import FlowConfig
from deep_sfm_revisited_tpu_torch.models.submodules import _resize_nchw
from deep_sfm_revisited_tpu_torch.ops.correlation import (local_correlation,
                                                          warped_correlation_nchw)
from deep_sfm_revisited_tpu_torch.utils.weights import pwc_encoder_names

_LRELU = 0.1
_ENC = (16, 32, 64, 96, 128, 196)
_DEC = (128, 128, 96, 64, 32)
_CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
# flow scale of each level's warp (upstream's 20 / 2^level), by level
_WARP_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}


def conv(cin: int, cout: int, stride: int = 1, dilation: int = 1) -> nn.Sequential:
    """3x3 conv with bias + leaky ReLU 0.1 (upstream's `conv`)."""
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, dilation, dilation=dilation),
                         nn.LeakyReLU(_LRELU))


def deconv(cin: int, cout: int) -> nn.ConvTranspose2d:
    """Exact 2x upsampling ConvTranspose2d(k=4, s=2, p=1) with bias."""
    return nn.ConvTranspose2d(cin, cout, 4, 2, 1)


def check_size(h: int, w: int) -> None:
    """Raise a ValueError unless PWC-DC takes an (h, w) input: both
    multiples of 64 (six stride-2 levels, each up-sampled by two)."""
    if h % 64 or w % 64:
        raise ValueError(f"PWC-DC takes H and W that are multiples of 64; got {h}x{w} (pad or "
                         "crop the pair to /64)")


def _correlate(f1: torch.Tensor, f2: torch.Tensor, md: int) -> torch.Tensor:
    """NCHW features -> NCHW (2md+1)^2 correlation, computed on float32
    NHWC copies and cast back to the features' dtype; differentiable in
    both (on the GPU B2 and its backward kernel)."""
    corr = local_correlation(f1.permute(0, 2, 3, 1).float().contiguous(),
                             f2.permute(0, 2, 3, 1).float().contiguous(), md)
    return corr.permute(0, 3, 1, 2).to(f1.dtype)


def _warped_correlate(f1: torch.Tensor, f2: torch.Tensor, up_flow: torch.Tensor, scale: float,
                      md: int) -> torch.Tensor:
    """NCHW features (channels-last in memory, as the encoder leaves them)
    and up-sampled flow (B, 2, h, w) -> NCHW correlation of f1 with f2
    warped by the flow times `scale` (JAX `warp_flow`, then the correlation
    of float32 casts), in the features' dtype: on the GPU one launch, with
    no permute, copy or cast around it; its gradient in f1, f2 and the flow
    one launch of the backward kernel (and in bfloat16 a cast)."""
    return warped_correlation_nchw(f1, f2, up_flow, scale, md)


class PWCDCNet(nn.Module):
    """PWC-DC flow network. Returns (flow, None)."""

    def __init__(self, cfg: FlowConfig, md: int = 4, div_flow: float = 20.0):
        super().__init__()
        self.cfg = cfg
        self.md = md
        self.div_flow = div_flow
        cin = 3
        for lvl, c in enumerate(_ENC, start=1):
            for j, name in enumerate(pwc_encoder_names(lvl)):
                self.add_module(name, conv(cin if j == 0 else c, c, stride=2 if j == 0 else 1))
            cin = c
        nd = (2 * md + 1) ** 2
        for lvl in (6, 5, 4, 3, 2):
            od = nd if lvl == 6 else nd + _ENC[lvl - 1] + 4
            for k, c in enumerate(_DEC):
                self.add_module(f"conv{lvl}_{k}", conv(od, c))
                od += c
            self.add_module(f"predict_flow{lvl}", nn.Conv2d(od, 2, 3, 1, 1))
            if lvl > 2:
                self.add_module(f"deconv{lvl}", deconv(2, 2))
                self.add_module(f"upfeat{lvl}", deconv(od, 2))
        for k, (c, dil) in enumerate(_CONTEXT):
            self.add_module(f"dc_conv{k + 1}", conv(od, c, dilation=dil))
            od = c
        self.dc_conv7 = nn.Conv2d(32, 2, 3, 1, 1)

    def encode(self, x: torch.Tensor):
        """(N, 3, H, W) -> features at strides 2..64, levels 1..6."""
        feats = []
        for lvl in range(1, 7):
            for name in pwc_encoder_names(lvl):
                x = getattr(self, name)(x)
            feats.append(x)
        return feats

    def decode(self, x: torch.Tensor, lvl: int):
        """DenseNet-connected decoder: each conv's output is prepended."""
        for k in range(len(_DEC)):
            x = torch.cat([getattr(self, f"conv{lvl}_{k}")(x), x], dim=1)
        return x, getattr(self, f"predict_flow{lvl}")(x)

    def forward(self, pair: torch.Tensor, all_iters: bool = False):
        """(B, H, W, 6) -> (flow (B, H, W, 2) float32, None); with `all_iters`
        (JAX's `train=True, all_iters=True`) the (5, B, H, W, 2) float32 stack
        of levels 6..2's flows, each times `div_flow` then resized to (H, W)
        (JAX `pwcnet.py:151-161`), the refined level-2 flow last. That order
        rounds the last entry apart from the eval flow `div_flow resize(flow)`,
        as in JAX."""
        B, H, W, _ = pair.shape
        check_size(H, W)
        x = pair.permute(0, 3, 1, 2)
        both = self.encode(torch.cat([x[:, :3], x[:, 3:]], dim=0))
        up_flow = up_feat = None
        flows = []
        for lvl in (6, 5, 4, 3, 2):
            f1, f2 = both[lvl - 1][:B], both[lvl - 1][B:]
            if up_flow is None:
                inp = F.leaky_relu(_correlate(f1, f2, self.md), _LRELU)
            else:
                corr = _warped_correlate(f1, f2, up_flow, _WARP_SCALE[lvl], self.md)
                inp = torch.cat([corr, f1, up_flow, up_feat], dim=1)
            feat, flow = self.decode(inp, lvl)
            flows.append(flow)
            if lvl > 2:
                up_flow = getattr(self, f"deconv{lvl}")(flow)
                up_feat = getattr(self, f"upfeat{lvl}")(feat)
        h = feat
        for k in range(1, 7):
            h = getattr(self, f"dc_conv{k}")(h)
        flow = flows[-1] = flow + self.dc_conv7(h)
        if all_iters:
            stack = [_resize_nchw(f.float() * self.div_flow, (H, W)) for f in flows]
            return torch.stack(stack).permute(0, 1, 3, 4, 2), None
        full = self.div_flow * _resize_nchw(flow.float(), (H, W))
        return full.permute(0, 2, 3, 1), None
