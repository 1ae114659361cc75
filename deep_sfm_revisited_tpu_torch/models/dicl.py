"""DICL coarse-to-fine optical flow (port of `models/dicl.py`), eval and train.

`FeatureGA` U-net features at strides 4..64 -> per level 6..2: the
(2md+1)^2-displacement stack of [x | shifted y] pairs with warp-hole
masking, where y is the level's target features warped by the upsampled
flow of the level before (`displacement_volume`: on the GPU one launch of
kernel B1's fused warp-and-displacement-volume entry point, on the CPU its
plain version, `shifted_pairs` of `warp_flow`), a shared matching net
folded over the displacement axis, the learned 1x1 cost smoothing,
soft-argmax flow and its entropy, and a dilated context net.

Module names follow the reference (`models/DICL_shallow.py`), so its
checkpoints load with `load_state_dict`. Displacements are stacked in the
JAX package's order (dv outer, du inner); the reference flattens (du
outer, dv inner), so `SmoothCost` keeps its weight in the reference's
order and permutes it to the JAX order when it runs.

In train mode the U-net runs once per frame (BN batch statistics per call,
JAX `dicl.py:264-272`) and `all_iters=True` returns the per-level flow stack
(`:356-361`); BN running statistics update as JAX's `mutable=
["batch_stats"]` step updates them. With autograd on (flow pretraining,
`train/flow_trainer.py`, or depth training with `train.fix_flownet=False`)
the gradient reaches the matching nets and the U-net through the
displacement volume's backward (`DisplacementVolumeFn`: kernel B1's
backward entry point on the GPU, autograd of the plain composition on the
CPU). The flow each level warps with is detached, as in JAX (`:348`), so
the volume has no flow gradient.

Layouts: `DICLFlow.forward` takes and returns NHWC like the JAX module;
the helpers below work on the internal NCHW tensors (features (B, C, H,
W), flow (B, 2, H, W) as (dx, dy), costs (B, S2, H, W)).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deep_sfm_revisited_tpu_torch.config import FlowConfig
from deep_sfm_revisited_tpu_torch.models.submodules import BatchNorm2d, _resize_nchw, no_autocast
from deep_sfm_revisited_tpu_torch.ops.camera import (_taps, bilinear_sample,
                                                    bilinear_sample_plain, pixel_grid)
from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp
from deep_sfm_revisited_tpu_torch.utils.weights import disp_transpose_perm


class BasicConv(nn.Module):
    """Conv (always bias-free) [+ BN] [+ ReLU]; `deconv` is the exact 2x
    upsampling ConvTranspose2d(k=4, s=2, p=1) (ref `BasicConv`)."""

    def __init__(self, cin, cout, kernel=3, stride=1, dilation=1, deconv=False,
                 bn=True, relu=True):
        super().__init__()
        if deconv:
            self.conv = nn.ConvTranspose2d(cin, cout, kernel, stride, 1, bias=False)
        else:
            pad = dilation if dilation > 1 else kernel // 2
            self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, dilation=dilation,
                                  bias=False)
        self.bn = BatchNorm2d(cout) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class Conv2x(nn.Module):
    """Stride-2 (de)conv, concat with the skip, fuse conv (ref `Conv2x`)."""

    def __init__(self, cin, cout, deconv=False):
        super().__init__()
        self.conv1 = BasicConv(cin, cout, 4 if deconv else 3, 2, deconv=deconv, bn=False)
        self.conv2 = BasicConv(2 * cout, cout, 3, 1)

    def forward(self, x, rem):
        return self.conv2(torch.cat([self.conv1(x), rem], dim=1))


class FeatureGA(nn.Module):
    """6-level shared U-net; NCHW (B, 3, H, W) -> [x2..x6], 32 channels at
    strides 4, 8, 16, 32, 64 (ref `FeatureGA`)."""

    _ENC = [32, 48, 64, 96, 128, 160, 192]

    def __init__(self):
        super().__init__()
        self.conv_start = nn.Sequential(BasicConv(3, 32, 3, 1), BasicConv(32, 32, 3, 2),
                                        BasicConv(32, 32, 3, 1))
        c = self._ENC
        for i in range(6):
            self.add_module(f"conv{i + 1}a", BasicConv(c[i], c[i + 1], 3, 2))
        for i, lvl in enumerate(range(6, 0, -1)):       # deconv6a..deconv1a
            self.add_module(f"deconv{lvl}a", Conv2x(c[6 - i], c[5 - i], deconv=True))
        for i in range(6):                              # conv1b..conv6b
            self.add_module(f"conv{i + 1}b", Conv2x(c[i], c[i + 1]))
        for i, lvl in enumerate(range(6, 1, -1)):       # deconv6b..deconv2b
            self.add_module(f"deconv{lvl}b", Conv2x(c[6 - i], c[5 - i], deconv=True))
            self.add_module(f"outconv_{lvl}", BasicConv(c[5 - i], 32, 3, 1))

    def forward(self, x):
        x = self.conv_start(x)
        rems = [x]
        for i in range(6):
            x = getattr(self, f"conv{i + 1}a")(x)
            rems.append(x)
        rems_a = [x]
        for lvl in range(6, 0, -1):
            x = getattr(self, f"deconv{lvl}a")(x, rems[lvl - 1])
            rems_a.append(x)
        # rems_a: [6a, 5a(160) .. 0a(32)]; encoder b skips from decoder a
        for i in range(5):
            x = getattr(self, f"conv{i + 1}b")(x, rems_a[5 - i])
            rems_a.append(x)
        x = self.conv6b(x, rems[6])
        rems_b = rems_a[7:]                             # conv1b..conv5b outputs
        outs = []
        for i, lvl in enumerate(range(6, 1, -1)):
            x = getattr(self, f"deconv{lvl}b")(x, rems_b[4 - i])
            outs.append(getattr(self, f"outconv_{lvl}")(x))
        return outs[::-1]


class Matching(nn.Module):
    """Matching net over [x | y] pairs (ref `MatchingShallow_down`, SHALLOW_Down)."""

    def __init__(self, cin=64):
        super().__init__()
        self.match = nn.Sequential(
            BasicConv(cin, 96, 3, 1), BasicConv(96, 128, 3, 2), BasicConv(128, 128, 3, 1),
            BasicConv(128, 64, 3, 1), BasicConv(64, 32, 4, 2, deconv=True),
            nn.Conv2d(32, 1, 3, 1, 1, bias=True))

    def forward(self, x):
        return self.match(x)


class SmoothCost(nn.Module):
    """Learned bias-free 1x1 conv across the S2 displacements (ref
    `smooth_cost`), identity-initialized (SMOOTH_INIT_BY_ID). The weight is
    stored in the reference's displacement order and applied in the JAX
    package's."""

    def __init__(self, s2: int):
        super().__init__()
        self.smooth_layer = BasicConv(s2, s2, 1, bn=False, relu=False)
        with torch.no_grad():
            self.smooth_layer.conv.weight.copy_(torch.eye(s2)[:, :, None, None])
        self.register_buffer("perm", torch.as_tensor(disp_transpose_perm(s2)),
                             persistent=False)

    def forward(self, cost):
        w = self.smooth_layer.conv.weight[self.perm][:, self.perm]
        return F.conv2d(cost, w)


def shifted_pairs(x: torch.Tensor, y: torch.Tensor, md: int,
                  mask_holes: bool = True) -> torch.Tensor:
    """(B, S2, 2C, H, W) displacement stack, S = 2 md + 1, dv outer / du
    inner: x[p] paired with y[p + (du, dv)], zero outside the frame; with
    `mask_holes` a pair whose shifted y is all-zero is zeroed
    (REMOVE_WARP_HOLE, JAX `shifted_pairs`)."""
    B, C, H, W = x.shape
    yp = F.pad(y, (md, md, md, md))
    stacks = []
    for dv in range(-md, md + 1):
        for du in range(-md, md + 1):
            ys = yp[:, :, dv + md:dv + md + H, du + md:du + md + W]
            m = torch.zeros((H, W), dtype=x.dtype, device=x.device)
            m[max(0, -dv):H - max(0, dv), max(0, -du):W - max(0, du)] = 1.0
            pair = torch.cat([x * m, ys * m], dim=1)
            if mask_holes:
                hole = torch.sum(torch.abs(ys), dim=1, keepdim=True) != 0
                pair = pair * hole.to(pair.dtype)
            stacks.append(pair)
    return torch.stack(stacks, dim=1)


def _displacements(md: int, dtype, device):
    disp = torch.arange(-md, md + 1, dtype=dtype, device=device)
    S = 2 * md + 1
    dv = disp.repeat_interleave(S)[None, :, None, None]   # dv outer
    du = disp.repeat(S)[None, :, None, None]              # du inner
    return du, dv


def flow_regression(cost: torch.Tensor, md: int,
                    truncated_size: Optional[int] = None) -> torch.Tensor:
    """Soft-argmax over the displacement axis of cost (B, S2, H, W) ->
    flow (B, 2, H, W); `truncated_size` masks the cost to a +-size window
    around the argmax displacement before the softmax."""
    du, dv = _displacements(md, cost.dtype, cost.device)
    if truncated_size is not None and truncated_size < 2 * md:
        amax = torch.argmax(cost, dim=1, keepdim=True)
        dv_a = dv[0, :, 0, 0][amax]
        du_a = du[0, :, 0, 0][amax]
        window = (torch.abs(dv - dv_a) <= truncated_size) & (torch.abs(du - du_a) <= truncated_size)
        cost = torch.where(window, cost, torch.full_like(cost, -float("inf")))
    prob = torch.softmax(cost, dim=1)
    return torch.cat([torch.sum(prob * du, dim=1, keepdim=True),
                      torch.sum(prob * dv, dim=1, keepdim=True)], dim=1)


def flow_entropy(cost: torch.Tensor) -> torch.Tensor:
    """Normalized softmax entropy (B, S2, H, W) -> (B, 1, H, W)."""
    S2 = cost.shape[1]
    p = torch.softmax(cost, dim=1)
    pc = torch.clamp(p, 1e-9, 1 - 1e-9)
    ent = -torch.sum(p * torch.log(pc), dim=1, keepdim=True)
    return ent / math.log(S2)


def warp_flow(y: torch.Tensor, flow: torch.Tensor, sample=None) -> torch.Tensor:
    """Backward-warp features y (B, C, H, W) by flow (B, 2, H, W) with zero
    fill, through `sample` (by default `bilinear_sample`: kernel B1's gather
    on the GPU)."""
    B, C, H, W = y.shape
    with no_autocast(y.device):
        grid = pixel_grid(H, W, torch.float32, y.device)[:2]          # (2, H, W)
        coords = (grid[None] + flow.float()).permute(0, 2, 3, 1)      # (B, H, W, 2)
    out = (sample or bilinear_sample)(y.permute(0, 2, 3, 1).contiguous(), coords)
    return out.permute(0, 3, 1, 2)


def displacement_volume_plain(x: torch.Tensor, y: torch.Tensor, flow: Optional[torch.Tensor],
                              md: int) -> torch.Tensor:
    """The displacement-volume kernel's plain PyTorch version: the
    (B, S2, 2C, H, W) stack `shifted_pairs(x, warp_flow(y, flow), md)` with
    the gather's plain version, or `shifted_pairs(x, y, md)` without a flow."""
    if flow is not None:
        y = warp_flow(y, flow, bilinear_sample_plain)
    return shifted_pairs(x, y, md)


def displacement_volume_backward_plain(dout: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                                       flow: Optional[torch.Tensor],
                                       md: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The displacement volume's backward kernel's plain PyTorch version:
    the explicit VJP of `displacement_volume_plain` with respect to x and y.

    dout (B, S2, 2C, H, W), the stack's gradient; x, y, flow, md as the
    forward took them. Returns (dx, dy), each (B, C, H, W) in dout's dtype,
    summed in float32 (float64 for float64 inputs). With keep_s(p) the
    forward's mask of displacement s = (dv + md) S + du + md at p (q = p + d_s
    in the frame, and some channel of the warped y at q non-zero):
    dx[p] = sum_s keep_s(p) dout[s, :C, p] and the warped y's gradient
    dyh[q] = hole(q) sum_s dout[s, C:, q - d_s] over p = q - d_s in the
    frame, both summed in s order, as the kernel sums them; without a flow
    dy = dyh, with one each q adds dyh[q] times its sample's four bilinear
    weights onto the taps the forward read (`index_add_`).

    Precondition of the kernel's agreement with it: y is finite. Where y
    holds NaN or Inf on a tap of a sample that leaves the frame, that
    sample's warped value is NaN (the tap times the validity 0), so this
    version and the forward keep it; the kernel does not, and its dx then
    lacks those terms (`tests/test_torch_cuda.py` shows the difference)."""
    B, C, H, W = x.shape
    S = 2 * md + 1
    cdt = torch.promote_types(dout.dtype, torch.float32)
    yw = y if flow is None else warp_flow(y, flow, bilinear_sample_plain)
    hole = (yw != 0).any(dim=1)                                      # (B, H, W)
    g = dout.to(cdt).reshape(B, S, S, 2, C, H, W)
    dx = torch.zeros((B, C, H, W), dtype=cdt, device=dout.device)
    dyh = torch.zeros((B, C, H, W), dtype=cdt, device=dout.device)

    def span(lo, hi):          # empty where the shift exceeds the map
        return slice(lo, max(lo, hi))

    for i, dv in enumerate(range(-md, md + 1)):
        py = span(max(0, -dv), H - max(0, dv))        # p rows whose q = p + d is in the frame
        qy = span(max(0, dv), H - max(0, -dv))
        for j, du in enumerate(range(-md, md + 1)):
            px = span(max(0, -du), W - max(0, du))
            qx = span(max(0, du), W - max(0, -du))
            keep = hole[:, None, qy, qx].to(cdt)
            dx[:, :, py, px] += g[:, i, j, 0, :, py, px] * keep
            dyh[:, :, qy, qx] += g[:, i, j, 1, :, py, px]
    dyh = dyh * hole[:, None].to(cdt)
    if flow is None:
        return dx.to(dout.dtype), dyh.to(dout.dtype)
    grid = pixel_grid(H, W, torch.float32, dout.device)[:2]
    coords = (grid[None] + flow.float()).reshape(B, 2, -1)
    valid, (yi, xi, yi1, xi1), (wx, wy) = _taps(coords[:, 0], coords[:, 1], H, W)
    # the weights' fractions as the forward's float32 blend rounds them
    wx, wy, ax, ay = (v.to(cdt) for v in (wx, wy, 1 - wx, 1 - wy))
    gw = dyh.reshape(B, C, -1) * valid[:, None].to(cdt)
    base = (torch.arange(B, device=dout.device) * (H * W))[:, None]
    acc = torch.zeros((B * H * W, C), dtype=cdt, device=dout.device)
    for yy, xx, w in ((yi, xi, ay * ax), (yi, xi1, ay * wx), (yi1, xi, wy * ax),
                      (yi1, xi1, wy * wx)):
        acc.index_add_(0, (base + yy * W + xx).reshape(-1),
                       (gw * w[:, None]).transpose(1, 2).reshape(-1, C))
    dy = acc.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return dx.to(dout.dtype), dy.to(dout.dtype).contiguous()


class DisplacementVolumeFn(torch.autograd.Function):
    """Kernel B1's displacement volume (forward) and its backward kernel
    (dx, dy) as one autograd function, for CUDA tensors. The flow gets no
    gradient: a flow that requires one is refused, as both packages detach
    it."""

    @staticmethod
    def forward(ctx, x, y, flow, md):
        if flow is not None and flow.requires_grad:
            raise NotImplementedError("the displacement volume has no flow gradient; detach "
                                      "the flow it warps with, as DICL does")
        ctx.md = md
        ctx.save_for_backward(y, flow)
        return sweep_warp.displacement_volume_cuda(x, y, flow, md)

    @staticmethod
    def backward(ctx, dout):
        y, flow = ctx.saved_tensors
        dx, dy = sweep_warp.displacement_volume_backward_cuda(dout.contiguous(), y, flow, ctx.md)
        return dx, dy, None, None


def displacement_volume(x: torch.Tensor, y: torch.Tensor, flow: Optional[torch.Tensor],
                        md: int) -> torch.Tensor:
    """One level's displacement stack (B, S2, 2C, H, W) of x and y
    (B, C, H, W) with y warped by flow (B, 2, H, W), or not warped where flow
    is None; differentiable in x and y. CUDA tensors go through kernel B1's
    fused entry point (one launch) and its backward (`DisplacementVolumeFn`),
    CPU tensors through `displacement_volume_plain`, which autograd
    differentiates. A flow that requires a gradient is refused."""
    sweep_warp.refuse_flow_gradient(flow)
    if x.device.type == "cuda":
        return DisplacementVolumeFn.apply(
            x.contiguous(), y.contiguous(), None if flow is None else flow.float().contiguous(),
            md)
    if x.device.type == "cpu":
        return displacement_volume_plain(x, y, flow, md)
    raise NotImplementedError(f"displacement_volume on {x.device.type}")


class DICLFlow(nn.Module):
    """Coarse-to-fine DICL flow; pair (B, H, W, 6), H and W multiples of 128."""

    _CONTEXT = [(64, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1)]

    def __init__(self, cfg: FlowConfig):
        super().__init__()
        self.cfg = cfg
        self.feature = FeatureGA()
        mds = list(cfg.dicl_search_range)           # fine -> coarse, levels 2..6
        for idx, lvl in enumerate((2, 3, 4, 5, 6)):
            self.add_module(f"matching{lvl}", Matching(64))
            if cfg.dicl_smooth_cost:
                self.add_module(f"cost_smooth{lvl}", SmoothCost((2 * mds[idx] + 1) ** 2))
            if cfg.dicl_ctf_context:
                layers, cin = [], 38
                for cout, dil in self._CONTEXT:
                    layers.append(BasicConv(cin, cout, 3, 1, dilation=dil))
                    cin = cout
                layers.append(nn.Conv2d(32, 2, 3, 1, 1, bias=True))
                self.add_module(f"context{lvl}", nn.Sequential(*layers))

    def _level_cost(self, xf, yf, flow, md, lvl):
        B, C, h, w = xf.shape
        stack = displacement_volume(xf, yf, flow, md)
        S2 = stack.shape[1]
        out = getattr(self, f"matching{lvl}")(stack.reshape(B * S2, 2 * C, h, w))
        cost = out.reshape(B, S2, h, w)
        if self.cfg.dicl_smooth_cost:
            cost = getattr(self, f"cost_smooth{lvl}")(cost)
        return cost.float()

    def forward(self, pair: torch.Tensor, all_iters: bool = False):
        """Returns (flow (B, H, W, 2), entropy (B, H, W, 1)), both float32;
        with `all_iters`, (the (L, B, H, W, 2) stack of every level's flow at
        full resolution, coarse to fine, with the pre-context flows when
        `dicl_sup_raw_flow`, entropy)."""
        cfg = self.cfg
        B, H, W, _ = pair.shape
        x_img = pair[..., :3].permute(0, 3, 1, 2)
        y_img = pair[..., 3:].permute(0, 3, 1, 2)
        if self.training:
            xs, ys = self.feature(x_img), self.feature(y_img)
        else:
            both = self.feature(torch.cat([x_img, y_img], dim=0))
            xs = [f[:B] for f in both]
            ys = [f[B:] for f in both]
        mds = list(cfg.dicl_search_range)
        scale_ctx = list(cfg.dicl_scale_context)
        flows_out: List[torch.Tensor] = []
        up_flow = entro = None
        for li, lvl in enumerate((6, 5, 4, 3, 2)):
            idx = 4 - li
            xf, yf = xs[idx], ys[idx]
            md = mds[idx]
            cost = self._level_cost(xf, yf, up_flow, md, lvl)
            flow = flow_regression(cost, md, cfg.dicl_truncated_size
                                   if cfg.dicl_truncated else None)
            if up_flow is not None:
                flow = flow + up_flow
            if cfg.dicl_sup_raw_flow and all_iters:
                flows_out.append(flow * (4 * 2 ** idx))
            if cfg.dicl_ctf_context:
                entro = flow_entropy(cost)
                g = _resize_nchw(x_img.to(xf.dtype), xf.shape[-2:])
                fin = torch.cat([flow.detach().to(xf.dtype), entro.detach().to(xf.dtype), xf, g],
                                dim=1)
                ctx = getattr(self, f"context{lvl}")(fin).float()
                flow = flow + ctx * scale_ctx[idx]
            flows_out.append(flow * (4 * 2 ** idx))
            if lvl > 2:
                up_flow = 2.0 * _resize_nchw(flow.detach(), xs[idx - 1].shape[-2:])
        entro0 = _resize_nchw(entro, (H, W)).permute(0, 2, 3, 1) if entro is not None else None
        if all_iters:
            return torch.stack([_resize_nchw(f, (H, W)).permute(0, 2, 3, 1)
                                for f in flows_out]), entro0
        return _resize_nchw(flows_out[-1], (H, W)).permute(0, 2, 3, 1), entro0
