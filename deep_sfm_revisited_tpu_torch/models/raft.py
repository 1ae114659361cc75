"""RAFT optical flow (port of `models/raft.py`), eval and train.

RAFT is the JAX package's default flow estimator (`FlowConfig.estimator`):
a 1/8-resolution feature encoder `fnet` (instance norm) over both frames,
one all-pairs correlation of its features pooled into a 4-level pyramid, a
context encoder `cnet` (batch norm) over the reference frame, and a
recurrence of `raft_iters_train` (12) or `raft_iters_eval` (24) updates:
look the pyramid up in a (2r+1)^2 window around the current
correspondences, encode the motion, step a separable ConvGRU, add the flow
head's update, and at the end upsample the flow x8 by a learned convex
combination of 3x3 neighbours.

Module names are upstream RAFT's (`fnet`, `cnet`, `update_block.encoder.
convc1`.., `update_block.gru.convz1`.., `update_block.flow_head.conv1`,
`update_block.mask.0`), so a reference state dict loads by name
(`utils/weights.py::raft_entries`). Where the JAX network departs from
upstream the port follows JAX:

- the gradient runs through the coordinates of every iteration (upstream
  detaches them): the lookup's backward gives d coords as well as d pyramid;
- fnet's instance norms carry a scale and a bias (flax `GroupNorm(num_groups=
  C)`), at identity unless carried from JAX;
- the correlation pyramid is bfloat16 whatever the network's dtype (the
  product in float32, divided by sqrt(C), then cast), and the lookup clips
  the coordinates to [-(r+2), size+r+1] and zero-fills each tap;
- RGB input (a reference checkpoint's conv1 is permuted from BGR when it
  loads); z|r of each GRU direction and the flow and mask heads' first
  convolutions run as one convolution each, from the upstream modules'
  weights; at eval the mask is computed once, from the final hidden state.

The lookup is `RaftLookupFn`: on CUDA tensors kernel R1 and, in its
backward, R2 (`ops/cuda/raft_lookup.py`, source `csrc/raft_lookup.cu`), one
launch of each an iteration over all levels; on CPU tensors the plain
versions `lookup_correlation_plain` and
`lookup_correlation_backward_accumulate_plain`, which the CPU tests hold to
the JAX function and its `jax.vjp`. The iterations' lookups of one forward
add their level gradients into one pyramid gradient (`PyramidGrad`), in
place, in the order autograd's sum of dense gradients would add them. The
pyramid is kept unpadded: the lookup zero-fills, so JAX's 11-pixel pad is
never made.

Layouts: `RAFT.forward` takes (B, H, W, 6) NHWC in [-1, 1], H and W
multiples of 8 (`check_size`), and returns (flow (B, H, W, 2) float32, None),
or with `all_iters` the (iters, B, H, W, 2) stack of every iteration's
upsampled flow; inside, feature maps are NCHW and the coordinates (B, h, w,
2) float32. The network's dtype is the autocast dtype where autocast is on
(bfloat16 on the main paths), else its parameters'.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from deep_sfm_revisited_tpu_torch.config import FlowConfig
from deep_sfm_revisited_tpu_torch.models.submodules import BatchNorm2d, no_autocast
from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup


def check_size(h: int, w: int) -> None:
    """Raise a ValueError unless RAFT takes an (h, w) input: both multiples
    of 8 (the encoders' three stride-2 stages; the x8 upsampling returns
    8 (h // 8) rows)."""
    if h % 8 or w % 8:
        raise ValueError(f"RAFT takes H and W that are multiples of 8; got {h}x{w} (pad or crop "
                         "the pair to /8)")


def _norm(kind: str, c: int) -> nn.Module:
    if kind == "instance":     # flax GroupNorm(num_groups=C, epsilon=1e-5): affine
        return nn.GroupNorm(c, c, eps=1e-5)
    if kind == "batch":
        return BatchNorm2d(c)
    return nn.Identity()


class ResBlock(nn.Module):
    """Upstream `ResidualBlock` (JAX `ResBlock`): two 3x3 convolutions with a
    norm and ReLU each, a 1x1 stride-s projection with a norm where the
    stride or width changes, ReLU of the sum."""

    def __init__(self, cin: int, cout: int, norm: str = "instance", stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1)
        self.norm1 = _norm(norm, cout)
        self.norm2 = _norm(norm, cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride), _norm(norm, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Upstream `BasicEncoder`: (N, 3, H, W) -> (N, out, H/8, W/8)."""

    def __init__(self, out: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.norm1 = _norm(norm, 64)
        layers, cin = [], 64
        for cout, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(ResBlock(cin, cout, norm, stride),
                                        ResBlock(cout, cout, norm, 1)))
            cin = cout
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = nn.Conv2d(128, out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


def correlation_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """JAX `correlation_pyramid`, unpadded: f1, f2 (B, C, h, w) -> `levels`
    bfloat16 maps (B h w, h / 2^i, w / 2^i). The all-pairs product is taken
    in float32 (float64 for float64 features) on the features as they come,
    divided by sqrt(C), cast to bfloat16, then 2x2-average-pooled level by
    level as flax's `avg_pool` of bfloat16 defines it: the window's four
    values summed in row-major order, each sum rounded to bfloat16, then
    divided by 4 (a float32 sum rounded once differs in a third of the
    values where the four cancel)."""
    B, C, h, w = f1.shape
    cdt = torch.promote_types(f1.dtype, torch.float32)
    with no_autocast(f1.device):
        a = f1.to(cdt).flatten(2).transpose(1, 2)
        b = f2.to(cdt).flatten(2)
        corr = (torch.matmul(a, b) / math.sqrt(C)).to(torch.bfloat16).reshape(B * h * w, h, w)
        pyramid = [corr]
        for _ in range(levels - 1):
            ho, wo = corr.shape[1] // 2, corr.shape[2] // 2
            c = corr[:, :2 * ho, :2 * wo]
            corr = (((c[:, 0::2, 0::2] + c[:, 0::2, 1::2]) + c[:, 1::2, 0::2])
                    + c[:, 1::2, 1::2]) / 4
            pyramid.append(corr)
    return pyramid


def _window(flat: torch.Tensor, i: int, Hl: int, Wl: int, r: int):
    """The window of every query at level i (JAX `lookup_correlation`,
    `:155-161`): the corner (x0, y0) as integers and the weights fx, fy in
    the coordinates' dtype, and clip' of x and y (1 inside the clip, 1/2 on
    its bounds as `jax.vjp` of `jnp.clip` gives at a tie, 0 beyond)."""
    c = flat / (2.0 ** i)
    out = []
    for k, size in ((0, Wl), (1, Hl)):
        lo, hi = -(r + 2.0), size + r + 1.0
        v = c[:, k]
        t = v.clamp(lo, hi) - r
        x0 = torch.floor(t)
        grad = torch.where((v > lo) & (v < hi), 1.0, torch.where((v == lo) | (v == hi), 0.5, 0.0))
        out.append((x0.long(), t - x0, grad.to(v.dtype)))
    return out


def _patch_index(x0: torch.Tensor, y0: torch.Tensor, Hl: int, Wl: int, S: int):
    """Flat indices into a level's rows of each query's S x S patch taps
    (Q, S, S), and which of them lie on the level."""
    offs = torch.arange(S, device=x0.device)
    yi = y0[:, None] + offs
    xi = x0[:, None] + offs
    valid = (((yi >= 0) & (yi < Hl))[:, :, None] & ((xi >= 0) & (xi < Wl))[:, None, :])
    idx = yi.clamp(0, Hl - 1)[:, :, None] * Wl + xi.clamp(0, Wl - 1)[:, None, :]
    return idx, valid


def _patch(level: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, dtype: torch.dtype):
    """The taps as float32 (JAX's patch), zero off the level, in `dtype`."""
    Q = level.shape[0]
    taps = torch.gather(level.reshape(Q, -1), 1, idx.reshape(Q, -1)).reshape(idx.shape)
    taps = torch.where(valid, taps.float(), torch.zeros((), device=taps.device))
    return taps.to(dtype)


def _compute_dtype(coords: torch.Tensor) -> torch.dtype:
    """The weights' and the blend's dtype: the coordinates' (JAX's fx), at
    least float32."""
    return torch.promote_types(coords.dtype, torch.float32)


def lookup_correlation_plain(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                             radius: int) -> torch.Tensor:
    """Kernel R1's plain PyTorch version (JAX `lookup_correlation`).

    levels (B h w, Hl, Wl), coords (B, h, w, 2) as (x, y) at 1/8 resolution ->
    (B, h, w, L (2r+1)^2): for each level i the window
        win[dy][dx] = (1-fy)(1-fx) p[dy][dx] + (1-fy) fx p[dy][dx+1]
                      + fy (1-fx) p[dy+1][dx] + fy fx p[dy+1][dx+1]
    of the (2r+2)^2 taps p at (y0 + s, x0 + t) (zero off the level) around
    the clipped coordinates / 2^i, flattened dx-major, levels in order.
    The taps are float32, as JAX's patch; the weights and the blend are in
    the coordinates' dtype (float32 on every path of the network, float64
    for float64 coordinates), each product and sum rounded in that order,
    as R1 does.
    """
    B, h, w, _ = coords.shape
    Q, r, S = B * h * w, radius, 2 * radius + 2
    flat = coords.reshape(Q, 2)
    cdt = _compute_dtype(coords)
    out = []
    for i, level in enumerate(levels):
        Hl, Wl = level.shape[1:]
        (x0, fx, _), (y0, fy, _) = _window(flat, i, Hl, Wl, r)
        p = _patch(level, *_patch_index(x0, y0, Hl, Wl, S), cdt)
        fx, fy = fx.to(cdt)[:, None, None], fy.to(cdt)[:, None, None]
        gx, gy = 1 - fx, 1 - fy
        win = (gy * gx * p[:, :-1, :-1] + gy * fx * p[:, :-1, 1:]
               + fy * gx * p[:, 1:, :-1] + fy * fx * p[:, 1:, 1:])
        out.append(win.transpose(1, 2).reshape(B, h, w, -1))
    return torch.cat(out, dim=-1)


def lookup_correlation_backward_plain(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                                      dout: torch.Tensor, radius: int):
    """Kernel R2's plain PyTorch version: the explicit VJP of
    `lookup_correlation_plain` (JAX's `jax.vjp` of `lookup_correlation`).

    levels, coords as the forward took them, dout (B, h, w, L (2r+1)^2) ->
    ([d level (B h w, Hl, Wl) in the levels' dtype], d coords in the
    coordinates' dtype). With g = dout in the compute dtype (the
    coordinates', at least float32) as win[dy][dx]:
        d p[s][t] = w11 g[s-1][t-1] + w10 g[s-1][t] + w01 g[s][t-1] + w00 g[s][t]
    (absent terms skipped), each term rounded to float32 and added in
    float32 in that order, as JAX's transpose adds the float32 patch's
    cotangents; placed at the taps on the level, zero elsewhere; and
        d x = sum_i clip'(x / 2^i) (dfx_i - d(1-fx)_i) / 2^i
    with d w_kl = sum over the window of g p_kl (y likewise). R2 adds this gradient into an
    accumulator (`lookup_correlation_backward_accumulate_plain`); this dense
    form is the reference the tests hold that one to.
    """
    B, h, w, _ = coords.shape
    Q, r, S, D = B * h * w, radius, 2 * radius + 2, 2 * radius + 1
    flat = coords.reshape(Q, 2)
    cdt = _compute_dtype(coords)
    g_all = dout.reshape(Q, len(levels), D, D).to(cdt)    # [q, level, dx, dy]
    dlevels, dcoords = [], torch.zeros((Q, 2), dtype=cdt, device=coords.device)
    for i, level in enumerate(levels):
        Hl, Wl = level.shape[1:]
        (x0, fx, mx), (y0, fy, my) = _window(flat, i, Hl, Wl, r)
        idx, valid = _patch_index(x0, y0, Hl, Wl, S)
        p = _patch(level, idx, valid, cdt)
        g = g_all[:, i].transpose(1, 2)                      # [q, dy, dx]
        fx, fy = fx.to(cdt)[:, None, None], fy.to(cdt)[:, None, None]
        gx, gy = 1 - fx, 1 - fy
        w00, w01, w10, w11 = gy * gx, gy * fx, fy * gx, fy * fx
        dp = torch.zeros((Q, S, S), device=coords.device)
        dp[:, 1:, 1:] += (w11 * g).float()
        dp[:, 1:, :-1] += (w10 * g).float()
        dp[:, :-1, 1:] += (w01 * g).float()
        dp[:, :-1, :-1] += (w00 * g).float()
        dl = torch.zeros((Q, Hl * Wl + 1), dtype=level.dtype, device=level.device)
        dl.scatter_(1, torch.where(valid, idx, Hl * Wl).reshape(Q, -1),
                    dp.to(level.dtype).reshape(Q, -1))
        dlevels.append(dl[:, :-1].reshape(Q, Hl, Wl))
        s00, s01, s10, s11 = ((g * q).sum(dim=(1, 2)) for q in
                              (p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1], p[:, 1:, 1:]))
        gx, gy, fx, fy = gx[:, 0, 0], gy[:, 0, 0], fx[:, 0, 0], fy[:, 0, 0]
        dx = (s01 * gy + s11 * fy) - (s00 * gy + s10 * fy)
        dy = (s10 * gx + s11 * fx) - (s00 * gx + s01 * fx)
        dcoords += torch.stack([dx * mx.to(cdt), dy * my.to(cdt)], dim=-1) / (2.0 ** i)
    return dlevels, dcoords.to(coords.dtype).reshape(coords.shape)


def lookup_correlation_backward_accumulate_plain(levels: Sequence[torch.Tensor],
                                                 coords: torch.Tensor, dout: torch.Tensor,
                                                 radius: int, grads: Sequence[torch.Tensor]):
    """Kernel R2's plain PyTorch version: `lookup_correlation_backward_plain`
    added into one accumulator a level (`grads`, each of its level's shape
    and dtype) in place, each element as
        buf = round(float(buf) + float(round(d p)))
    (round: to the levels' dtype; float: at least float32), what adding the
    dense gradients in that dtype gives. Returns d coords."""
    dlevels, dcoords = lookup_correlation_backward_plain(levels, coords, dout, radius)
    for acc, d in zip(grads, dlevels):
        cdt = torch.promote_types(acc.dtype, torch.float32)
        acc.copy_((acc.to(cdt) + d.to(cdt)).to(acc.dtype))
    return dcoords


def zeros_like_pyramid(levels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One contiguous zero tensor a level, views of one buffer filled at
    once (each level starting on 128 bytes)."""
    offsets, n = [], 0
    for lv in levels:
        offsets.append(n)
        n += -(-lv.numel() * lv.element_size() // 128) * 128 // lv.element_size()
    flat = torch.zeros(n, dtype=levels[0].dtype, device=levels[0].device)
    return [flat[o:o + lv.numel()].view(lv.shape) for o, lv in zip(offsets, levels)]


class PyramidGrad:
    """One gradient of the correlation pyramid for all the lookups of one
    RAFT forward, which its iterations' lookups add into in place (JAX's
    scan transpose adds the iterations' level gradients likewise, in the
    levels' dtype, last iteration first).

    Each lookup registers in its forward (`register`, 0, 1, ...). In a
    backward pass the lookups come last-registered first (autograd's order:
    each iteration's coordinates depend on the iteration before, so lookup
    i's gradient needs lookup i+1's); the first to come zero-fills one
    accumulator a level (`begin`), each adds into them, and lookup 0, which
    every pass through a RAFT forward reaches, hands them to autograd and
    ends the pass (`end`); the others hand None. A lookup out of that order,
    or a pass that ends without lookup 0, raises: the pyramid's gradient
    would be wrong. A second backward through the same graph starts a new
    pass with fresh accumulators."""

    def __init__(self):
        self.count = 0
        self.grads = None
        self.last = None

    def register(self) -> int:
        self.count += 1
        return self.count - 1

    def begin(self, index: int, levels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The accumulators lookup `index` adds into."""
        if self.grads is None:
            self.grads = zeros_like_pyramid(levels)
            torch.autograd.Variable._execution_engine.queue_callback(self._check_ended)
        elif index >= self.last:
            self.grads = None
            raise RuntimeError(f"RAFT's lookups ran their backward out of order: lookup {index} "
                               f"after lookup {self.last} in one pass (the pyramid's gradient "
                               "is added last iteration first)")
        self.last = index
        return self.grads

    def end(self, index: int) -> List[torch.Tensor | None]:
        """What lookup `index` hands autograd for the levels."""
        if index:
            return [None] * len(self.grads)
        grads, self.grads, self.last = self.grads, None, None
        return grads

    def _check_ended(self) -> None:
        if self.grads is not None:
            last, self.grads, self.last = self.last, None, None
            raise RuntimeError(f"a backward pass reached RAFT's lookups down to lookup {last} "
                               "but not lookup 0, which hands the pyramid's gradient to "
                               "autograd: the gradient would be lost")


class RaftLookupFn(torch.autograd.Function):
    """The lookup and its gradient in the levels and the coordinates:
    kernels R1 and R2 on CUDA tensors, `lookup_correlation_plain` and
    `lookup_correlation_backward_accumulate_plain` on CPU tensors. The
    window comes out in `out_dtype` (the network's dtype). The level
    gradients go into `acc`, the `PyramidGrad` shared by the lookups of one
    RAFT forward (a lookup without one gets its own; where the levels need
    no gradient, what it adds is dropped)."""

    @staticmethod
    def forward(ctx, coords, radius, out_dtype, acc, *levels):
        if coords.is_cuda:
            out = raft_lookup.raft_lookup_cuda(coords, levels, radius, out_dtype)
        else:
            out = lookup_correlation_plain(levels, coords, radius).to(out_dtype)
        ctx.radius = radius
        ctx.acc = PyramidGrad() if acc is None else acc
        ctx.index = ctx.acc.register()
        ctx.save_for_backward(coords, *levels)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        coords, *levels = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = ctx.acc.begin(ctx.index, levels)
        if dout.is_cuda:
            dcoords = raft_lookup.raft_lookup_backward_cuda(coords, levels, dout, ctx.radius,
                                                            grads)
        else:
            dcoords = lookup_correlation_backward_accumulate_plain(levels, coords, dout,
                                                                   ctx.radius, grads)
        dlevels = ctx.acc.end(ctx.index)
        return (dcoords if need[0] else None, None, None, None,
                *(d if n else None for d, n in zip(dlevels, need[4:])))


def lookup_correlation(levels: Sequence[torch.Tensor], coords: torch.Tensor, radius: int,
                       out_dtype: torch.dtype, acc: PyramidGrad | None = None) -> torch.Tensor:
    """The lookup through `RaftLookupFn` (JAX `lookup_correlation(...)
    .astype(out_dtype)`): (B, h, w, L (2r+1)^2) in `out_dtype`; its level
    gradients go into `acc` where given."""
    return RaftLookupFn.apply(coords.contiguous(), radius, out_dtype, acc, *levels)


class SepConvGRU(nn.Module):
    """Upstream `SepConvGRU`: a 1x5 then a 5x1 ConvGRU. z and r of a
    direction run as one convolution of their concatenated weights (JAX's
    fused kernel)."""

    def __init__(self, hidden: int = 128, input_dim: int = 256):
        super().__init__()
        c = hidden + input_dim
        self.hidden = hidden
        for k, (ks, pad) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))), start=1):
            for g in "zrq":
                self.add_module(f"conv{g}{k}", nn.Conv2d(c, hidden, ks, padding=pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        H = self.hidden
        for k in (1, 2):
            cz, cr, cq = (getattr(self, f"conv{g}{k}") for g in "zrq")
            zr = F.conv2d(torch.cat([h, x], dim=1), torch.cat([cz.weight, cr.weight]),
                          torch.cat([cz.bias, cr.bias]), padding=cz.padding)
            z, r = torch.sigmoid(zr[:, :H]), torch.sigmoid(zr[:, H:])
            q = torch.tanh(cq(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class MotionEncoder(nn.Module):
    """Upstream `BasicMotionEncoder`: correlation and flow -> 128 channels
    (126 encoded and the flow)."""

    def __init__(self, cor_planes: int = 324):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class FlowHead(nn.Module):
    """Upstream `FlowHead`'s two convolutions, under its names;
    `UpdateBlock` runs them (the first fused with the mask head's)."""

    def __init__(self, cin: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)


class UpdateBlock(nn.Module):
    """Upstream `BasicUpdateBlock` (JAX `UpdateBlock`): motion encoder, GRU,
    flow head and the upsampling mask head (x 0.25). With `need_mask` the
    two heads' first 3x3 convolutions run as one 512-out convolution (JAX's
    fused `Conv_0`); without it only the flow head's half runs; `mask_only`
    gives the mask of a hidden state (eval's final mask)."""

    def __init__(self, hidden: int = 128, context: int = 128, cor_planes: int = 324):
        super().__init__()
        self.encoder = MotionEncoder(cor_planes)
        self.gru = SepConvGRU(hidden, context + 128)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(nn.Conv2d(hidden, 256, 3, padding=1), nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp=None, corr=None, flow=None, need_mask: bool = True,
                mask_only: bool = False):
        fh, m0, m2 = self.flow_head, self.mask[0], self.mask[2]
        if mask_only:
            return m2(F.relu(m0(net))) * 0.25
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        if need_mask:
            heads = F.conv2d(net, torch.cat([fh.conv1.weight, m0.weight]),
                             torch.cat([fh.conv1.bias, m0.bias]), padding=1)
            n = fh.conv1.out_channels
            dflow = fh.conv2(F.relu(heads[:, :n]))
            mask = m2(F.relu(heads[:, n:])) * 0.25
        else:
            dflow = fh.conv2(F.relu(fh.conv1(net)))
            mask = None
        return net, mask, dflow


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """JAX `convex_upsample`: flow (B, h, w, 2), mask (B, h, w, 576) laid
    out (9, 8, 8) neighbour-major -> (B, 8h, 8w, 2): each fine pixel is the
    softmax(mask)-weighted sum of 8 x the flow at the 3x3 coarse neighbours
    (zero beyond the frame)."""
    B, h, w, _ = flow.shape
    m = torch.softmax(mask.reshape(B, h, w, 9, 8, 8), dim=3)
    fp = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    patches = torch.stack([fp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                          dim=3)                                       # (B, h, w, 9, 2)
    up = torch.sum(m[..., None] * patches[:, :, :, :, None, None, :], dim=3)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, 8 * h, 8 * w, 2)


def network_dtype(device: torch.device, param: torch.Tensor) -> torch.dtype:
    """The autocast dtype where autocast is on for `device`, else the
    parameters' dtype (JAX's `dtype` of the module)."""
    if torch.is_autocast_enabled(device.type):
        return torch.get_autocast_dtype(device.type)
    return param.dtype


class RAFT(nn.Module):
    """RAFT flow network. Returns (flow, None): RAFT gives no confidence."""

    def __init__(self, cfg: FlowConfig):
        super().__init__()
        self.cfg = cfg
        hd, cd = cfg.raft_hidden_dim, cfg.raft_context_dim
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hd + cd, "batch")
        self.update_block = UpdateBlock(hd, cd,
                                        cfg.raft_corr_levels * (2 * cfg.raft_corr_radius + 1) ** 2)

    def forward(self, pair: torch.Tensor, all_iters: bool = False):
        """(B, H, W, 6) -> (flow (B, H, W, 2) float32, None) after
        `raft_iters_eval` iterations in eval mode, `raft_iters_train` in
        train mode; with `all_iters` the (iters, B, H, W, 2) float32 stack of
        every iteration's upsampled flow (JAX `all_iters=True`)."""
        cfg = self.cfg
        B, H, W, _ = pair.shape
        check_size(H, W)
        dev, hd = pair.device, cfg.raft_hidden_dim
        d = network_dtype(dev, self.fnet.conv1.weight)
        x = pair.permute(0, 3, 1, 2)
        ref, tgt = x[:, :3], x[:, 3:]
        fmaps = self.fnet(torch.cat([ref, tgt]).contiguous(memory_format=torch.channels_last))
        pyramid = correlation_pyramid(fmaps[:B], fmaps[B:], cfg.raft_corr_levels)
        cmap = self.cnet(ref.contiguous(memory_format=torch.channels_last))
        net, inp = torch.tanh(cmap[:, :hd]), F.relu(cmap[:, hd:])

        h, w = H // 8, W // 8
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        coords0 = torch.stack([gx, gy], dim=-1)[None].expand(B, h, w, 2)
        coords1 = coords0.contiguous()
        iters = cfg.raft_iters_train if self.training else cfg.raft_iters_eval
        flows, masks = [], []
        # the iterations' lookups add into one pyramid gradient
        acc = PyramidGrad() if torch.is_grad_enabled() and pyramid[0].requires_grad else None
        for _ in range(iters):
            corr = lookup_correlation(pyramid, coords1, cfg.raft_corr_radius, d, acc)
            flow = (coords1 - coords0).to(d)
            net, mask, dflow = self.update_block(net, inp, corr.permute(0, 3, 1, 2),
                                                 flow.permute(0, 3, 1, 2), need_mask=all_iters)
            coords1 = coords1 + dflow.permute(0, 2, 3, 1).float()
            if all_iters:
                flows.append(coords1 - coords0)
                masks.append(mask.float().permute(0, 2, 3, 1))
        if all_iters:
            with no_autocast(dev):
                return torch.stack([convex_upsample(f, m) for f, m in zip(flows, masks)]), None
        mask = self.update_block(net, mask_only=True).float().permute(0, 2, 3, 1)
        with no_autocast(dev):
            return convex_upsample(coords1 - coords0, mask), None
