"""PoseNet: direct 6-DoF pose regression (port of `models/posenet.py`, `PlainPose`).

The route `pose.estimator="POSENET"`: a shared frame encoder over ref and
target, the downsampled flow and its confidence, five stride-2 conv stacks,
a global average pool and a 1x1 head regress (rot3, unit trans3), with the
reference's 0.01 output scale (`models/PoseNet.py:13-68`). Module names
follow the reference (`posenet.conv.{i}`, `posenet.pose_agg.{i}`,
`posenet.pose_reg`), so its checkpoints load with `load_state_dict`.
Batch normalization is flax's rule in train mode (`models/submodules.py::
BatchNorm2d`); the shared encoder runs once per image, so each call moves
the running statistics, as the JAX module's two calls do.

The deeper `ResNetPose` and `MotionNet` of the JAX module are on no route
of the composite and are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from deep_sfm_revisited_tpu_torch.models.submodules import BatchNorm2d, _resize_nchw

# (out channels, kernel, stride) of the shared frame encoder and of the
# aggregation stack after the concat
ENCODER_PLAN = ((16, 5, 2), (32, 3, 2), (64, 3, 1), (128, 3, 1), (128, 3, 1), (128, 3, 1),
                (64, 3, 1))
AGG_PLAN = ((128, 5, 2), (64, 3, 2), (32, 3, 2), (16, 3, 2), (16, 3, 2))


def conv_bn_relu(cin: int, cout: int, kernel: int, stride: int) -> nn.Sequential:
    """Biased conv, "SAME"-style padding (k - 1) / 2, BN, ReLU (JAX `_ConvBNRelu`)."""
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2),
                         BatchNorm2d(cout), nn.ReLU())


def _stack(cin: int, plan) -> nn.Sequential:
    layers = []
    for cout, k, s in plan:
        layers.append(conv_bn_relu(cin, cout, k, s))
        cin = cout
    return nn.Sequential(*layers)


class PlainPose(nn.Module):
    """(flow, ref, target, conf) -> (B, 6) = (rot3, unit trans3), float32.

    flow (B, H, W, 2), ref and target (B, H, W, 3), conf (B, H, W, 1) or None
    (then zeros), NHWC as the JAX module takes them.
    """

    def __init__(self):
        super().__init__()
        self.conv = _stack(3, ENCODER_PLAN)
        self.pose_agg = _stack(64 + 64 + 2 + 1, AGG_PLAN)
        self.pose_reg = nn.Conv2d(AGG_PLAN[-1][0], 6, 1)

    def forward(self, flow, ref, target, conf=None) -> torch.Tensor:
        x1 = self.conv(ref.permute(0, 3, 1, 2))
        x2 = self.conv(target.permute(0, 3, 1, 2))
        hw = x1.shape[-2:]
        if conf is None:
            conf = torch.zeros(flow.shape[:3] + (1,), dtype=flow.dtype, device=flow.device)
        flow_d = _resize_nchw(flow.permute(0, 3, 1, 2).to(x1.dtype), hw)
        conf_d = _resize_nchw(conf.permute(0, 3, 1, 2).to(x1.dtype), hw)
        x = self.pose_agg(torch.cat([x1, x2, flow_d, conf_d], dim=1))
        x = x.mean(dim=(2, 3), keepdim=True)                 # global average pool
        pose = 0.01 * self.pose_reg(x)[:, :, 0, 0].float()
        t = pose[:, 3:]
        t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
        return torch.cat([pose[:, :3], t], dim=-1)
