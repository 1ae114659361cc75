#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deep_sfm_revisited_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA device

Phases, each of which raises on failure:

1. setup: the card's name and power limit, TF32 off, kernels B1 (the
   generic gather, DICL's displacement volume and its backward, the
   plane-sweep cost volume and its two gradients, one source, and the
   PyTorch operators that launch them) and B2 (the windowed correlation,
   PWC-DC's warped correlation, both correlations' backward kernels, and
   their operators), R1/R2 (RAFT's correlation lookup and its backward,
   and their operators) and K1/K2 (REGNet's sweep correlation and its
   backward, and their operators) built with nvcc (in parallel) from
   `deep_sfm_revisited_tpu_torch/csrc/sweep_warp.cu`,
   `csrc/sweep_warp_ops.cpp`, `csrc/local_corr.cu`, `csrc/warped_corr.cu`,
   `csrc/warped_corr_backward.cu`, `csrc/local_corr_ops.cpp`,
   `csrc/raft_lookup.cu`, `csrc/raft_lookup_ops.cpp`, `csrc/sweep_corr.cu`
   and `csrc/sweep_corr_ops.cpp`;
2. pose on the card: rigid flow of a known (R, t) -> correspondence
   sampler -> five-point RANSAC in float64 recovers the pose, the
   zero-parallax probe gives a finite pose, and with noise and outliers
   added the card's RANSAC equals the CPU's on the same samples;
3. small-input reference: a 128x128 SFMNet in float32 on the card against
   the same weights and random draws on the CPU, where the port runs its
   plain versions (the CPU tests hold those against the JAX package), once
   with DICL flow and once with PWC-DC flow;
4. slice 1's main path: SFMNet eval under the KITTI recipe (DICL flow ->
   entropy sampler -> 512x5-hypothesis five-point RANSAC in float64 ->
   PSNet with 128 planes) at 384x1280, b=1, bf16 autocast, random weights
   from a seed, as `bench.py` runs the JAX package. One warm-up pair
   records B1's inputs; then the launch counts go to 0, three distinct
   pairs run, and each must have launched the sweep kernel once (PSNet's
   cost volume), the displacement volume five times (DICL's levels 6..2,
   the flow warp of levels 5..2 fused in) and the generic gather no time;
5. slice 2's main path, through the entry point a user calls: a golden
   KITTI raw tree rendered at 370x1224 (`data/synthetic.py`) evaluated by
   `cli.main([... "-v", "--override", "flow.estimator=PWC", ...])` (PWC-DC
   flow -> uniform sampler -> the same RANSAC -> PSNet, padded to 384x1280,
   bf16) on the card. The launch counts go to 0 before it; the warm-up
   pair records the inputs of B1's sweep, of B2 and of the warped
   correlation, the counts go to 0 again, and each of the three test pairs
   after it must launch the warped correlation four times (PWC-DC's flow
   warp and correlation at levels 5..2, one kernel a level), B2 once (level
   6), the sweep kernel once and the generic gather and the displacement
   volume no time; the result must be the 9 Eigen metrics, finite;
6. B1 against its plain PyTorch versions on the inputs both main paths
   gave it, in bf16 and float32, bit for bit: the generic gather on the
   warps PWC-DC's warped correlation computes (its f2 and coordinates), with
   out-of-range and behind-the-camera coordinates added,
   its time (CUDA events, and on the device from torch.profiler) beside the
   plain version's, `F.grid_sample`'s (both ways) and the bound; the sweep kernel on
   PSNet's inputs and on copies with a bordered target map, a pose that
   puts the near planes behind the camera and one that pushes most samples
   out of the frame, with exact zeros where the sample is invalid; its
   device and events times, bound and share of it, the plain version's
   time, and the device time of the composition it replaced
   (coordinates, the generic gather, the concat and the channels-last-3d
   copy that stands in for cuDNN's input transpose); the gather's host time
   per call piece by piece (the earlier ctypes wrapper rebuilt beside the
   operator),
   its events time per pair against `F.grid_sample`'s, and the four flow
   warps captured in a CUDA graph, whose replay must equal eager calls;
7. B2 against its plain PyTorch version on the inputs slice 2 gave it at
   level 6 and, at levels 5..2, on those the composition the warped
   correlation replaced would give it (f1 and the gathered f2 in float32),
   on a copy whose frame border holds large values, and on two odd shapes
   (C = 40 split across a cluster, C = 3 on the scalar staging path);
   two launches on the same inputs bit-identical; per level the work
   mapping, the device and events times, the plain version's time, the
   bound and the share of the bound reached; then the warped correlation
   on slice 2's inputs at levels 5..2 as PWC-DC holds them (channels-last
   features and the up-sampled flow in bf16), in bf16 and float32 and with
   flows sending samples off the frame: within its plain version's
   tolerance (plus one bf16 ulp of a bf16 output), two launches
   bit-identical, and bit for bit against the CUDA composition it replaced
   (gather, casts, B2, cast back) where both split the channels alike; per
   level the
   mapping with its registers, shared memory and resident blocks, device,
   CUDA-graph and events times, the bound of this interface and of the
   earlier NHWC float32 one with shares, the plain version's time, and
   PWC-DC's span (`pwcnet._warped_correlate`, one kernel) with its device
   time and kernel count; with `--old-b2 PATH` an earlier `local_corr.cu`'s
   NHWC warped correlation and the span PWC-DC ran around it (permutes,
   copies, casts) timed in turns with the current ones; and PWC-DC's five
   correlations of a pair replayed from a CUDA graph, equal to eager calls;
8. a small-input training reference: one train step at 128x128 (nlabel 8,
   float32, TF32 off) on the card against the same step on the CPU (plain
   versions) with the same weights, batch, noise and RANSAC draws, at the
   card's pose: the loss, and PSNet's gradients with the float32
   conditioning the phase measures on the CPU alone; then the same on the
   POSENET route (both devices online, PoseNet's gradients with PSNet's,
   the pose gradient launched once); on both routes the ReLU units whose
   sign differs between the devices must have inputs within rounding of
   zero, and the CPU step rerun with the card's ReLU masks must give the
   card's gradients to 1e-3;
9. slice 5's main path, through the entry point a user calls:
   `cli.main` in training mode on a golden KITTI raw tree rendered at
   370x1224, cropped to the recipe's 256x768, b = 4, nlabel 128, bf16, the
   slices' pose overrides; one warm-up step (which records the sweep
   backward's inputs), the launch counts reset, five timed steps, each of
   which must launch the displacement volume 5 times, the sweep and the
   sweep backward once and the gather and the sweep pose gradient no time,
   give a finite loss, leave DICL's parameters bit-identical
   while its BN statistics move, and move PSNet's parameters; ms/step, the
   stage split and peak memory; then the epoch's validation and checkpoint;
10. the sweep backward against its plain version on the inputs slice 5
   gave it, in bf16 and float32, and on behind-camera and out-of-frame
   variants (exact zeros where no sample lands, dref bit-identical across
   launches); the work mapping: tile groups on the shared and the direct
   path, samples that left their box and 16-byte global reductions, as the
   kernel counts them, which must equal the plain box rule's, and the
   distribution of box sizes; device and events times, bound and share,
   the plain version's time and the yardstick's, `grid_sampler_2d_backward`
   (the tgt half) plus the `sum(dim=1)` that gives dref, together and the
   tgt half alone;
11. slice 7's pose tools through `cli.main` on a golden KITTI VO tree
   rendered at 370x1226 (test sequences 9 and 10, train sequence 0),
   padded to 384x1280, DICL flow, bf16: `--record-pose` (after a warm-up
   pair, which records the displacement volume's inputs, each pair
   launches the displacement volume 10 times and the gather and the sweep
   no time; ms per pair and the flow / pose split; the six error keys,
   num_matches, uniform_fallback, the odometry report per test sequence,
   whose links launch the displacement volume 5 times each), `--save-pose`
   (both splits' stacks), and training with `pred_pose_online=False` on the
   saved poses (b = 4, 256x768, a warm-up and two steps, each launching the
   sweep and its backward once and the gather and the displacement volume
   no time);
12. slice 7's POSENET training step: phase 9 with `pose.estimator=POSENET`
   (each step also launches the sweep pose gradient once; the loss has its
   pose term; PoseNet's and PSNet's parameters move, DICL's do not);
13. the sweep pose gradient against its plain version on the inputs phase
   12 gave it, in bf16 and float32, and on behind-camera, out-of-frame and
   all-behind variants (exactly zero there), bit-identical across two
   launches; device and events times, the bound (dvol read only for the
   valid samples) and share, the plain version's time and the yardstick's,
   `grid_sampler_2d_backward`'s grid gradient; with `--old-b1 PATH`, an
   earlier `sweep_warp.cu`'s pose gradient timed beside it in turns (old,
   new, new, old);
14. DICL's displacement volume against its plain version (`shifted_pairs`
   of `warp_flow` with the gather's plain version) on the inputs slice 1,
   the training step and `--record-pose` gave it, in bf16 and float32, bit
   for bit, and two launches bit for bit; per level of slice 1's pair and
   of the training step, the work mapping (`displacement_plan`), device
   and events times, the bound and share, the plain version's time, and
   the device time and kernel count of the eager composition it replaced;
   with `--old-b1 PATH`, an earlier `sweep_warp.cu`'s displacement volume
   timed beside it level by level in turns (old, new, new, old);

15. a small-input flow-training reference: one DICL flow-pretraining step
   (`train/flow_trainer.py::FlowTrainer`, float32, TF32 off) at 128x128 on
   the card against the same step on the CPU from the same weights and
   batch: loss and EPE, and DICL's clipped gradients at twice the CPU's own
   sensitivity to a 1e-6 change of the input, 1 - cosine <= 1e-4; the card
   launches the displacement volume and its backward 5 times each;
16. slice 9's main path, through the entry point a user calls:
   `cli.main(["--train-flow", "--flow-dataset", "kitti", "--flow-crop",
   "256", "768", "-b", "4", "--epochs", "1", ...])` on a KITTI 2015 flow
   tree of 24 pairs rendered at 375x1242 (exact flow of the analytic
   scene, sparse valid mask, KITTI's 16-bit format), DICL at the recipe's
   widths, bf16: one warm-up step (which records the displacement volume's
   inputs and gradients), the launch counts reset, five timed steps, each
   of which must launch the displacement volume and its backward 5 times
   each and no other kernel, give a finite loss and EPE and move DICL's
   parameters and BN statistics; ms/step, the stage split (feature net,
   levels, loss + backward, optimizer), peak memory; the validation's EPE
   and Fl-all over the 24 pairs at 384x1280, finite; the checkpoint, which
   `--pretrained-flow` restores into an SFMNet with every DICL tensor equal
   and PSNet untouched;
17. the displacement volume's backward against its plain version on the
   gradients and inputs of phase 16's five levels, in bf16 and float32, on
   copies with out-of-frame samples and all-zero regions of y, at md 0 and
   4; dx bit for bit, dy bit for bit without a flow and within one
   float32-atomics rounding with one; two launches; per level device and
   events times, the device operations a call puts on the card, the bound
   and share, the plain version's time, and the yardsticks: autograd of the
   eager composition and `grid_sampler_2d_backward`'s input gradient (the
   scatter half); with `--old-b1` naming a source whose backward takes a
   hole buffer (the first kernel), that kernel timed in turns per level;
18. the frozen-flow depth-training step on the PWC-DC route through
   `cli.main` in training mode (`--override flow.estimator=PWC` on slice
   5's rendered tree, 256x768 crops, b = 4, bf16, full width): a warm-up
   and two timed steps, each with a finite loss, PWC-DC's parameters
   bit-identical, PSNet's moved, and B2 once, the warped correlation four
   times, the sweep and its backward once and no other kernel launched;
   ms per step by the host clock and peak memory; the epoch's validation;
   the warm-up step records the warped correlation's inputs;
19. the warped correlation on the inputs phase 18's step gave it (b = 4,
   256x768, levels 5..2), as phase 7 holds it on slice 2's, with `--old-b2`
   in turns too; no path so far has launched a correlation's backward;
20. a small-input PWC-DC flow-training reference: one `FlowTrainer` step
   with `flow.estimator=PWC` at 128x128, b = 2, float32, TF32 off, on the
   card against the same step on the CPU from the same weights and batch:
   loss and EPE, and PWC-DC's clipped gradients at twice the CPU's own
   sensitivity; the card launches B2 and its backward once each and the
   warped correlation and its backward four times each;
21. slice 13's main path, through the entry point a user calls:
   `cli.main(["--train-flow", ..., "--flow-crop", "256", "768", "-b", "4",
   "--override", "flow.estimator=PWC"])` on a KITTI 2015 flow tree of 24
   pairs rendered at 384x1280 (PWC-DC takes /64 sides and the CLI pads to
   /8), PWC-DC at full width, bf16: a warm-up step that records both
   backward kernels' inputs and gradients, then five timed steps, each
   launching B2 and its backward once, the warped correlation and its
   backward four times and no B1 kernel, with a finite loss and EPE and
   every PWC-DC parameter moved; ms/step, the stage split, peak memory; the
   validation's EPE and Fl-all; `--pretrained-flow` into an SFMNet with
   every PWC-DC tensor equal;
22. the two backward kernels against their plain versions on phase 21's
   captured inputs and gradients, level by level, in bf16 and float32 (B2's
   in float32), with off-frame and edge-exact flows; B2's gradients and
   the warped d f1 and d flow bit-identical across two launches, d f2
   within the atomics' rounding; per level the device and events times,
   the bound and its share, the plain version's time and the yardsticks
   (autograd of the eager composition, `grid_sampler_2d_backward`), the
   mapping `backward_plan` chose with its registers, shared memory and
   resident blocks; with `--old-b2-backward PATH` an earlier
   `warped_corr_backward.cu` (whose entry points take no mapping arguments)
   on the same inputs, within the same tolerance and timed in turns with
   the current kernels (old, new, new, old) by CUDA graph and on the device;
23. a small RAFT reference (slice 15): RAFT's flow net in float32 at
   128x128 on the card against the CPU (the plain lookup there), 24 eval
   iterations, then one RAFT `FlowTrainer` step (12 iterations, b = 2):
   flow, loss, EPE and clipped gradients held as phase 20 holds PWC-DC's;
   the eval launches R1 24 times, the step R1 and R2 12 times each;
24. slice 15's eval path through `cli.main -v --override flow.estimator=RAFT`
   on phase 5's rendered 370x1224 tree (RAFT at the JAX defaults, 24
   iterations -> uniform sampler -> RANSAC -> PSNet, 384x1280, bf16): a
   warm-up pair that records R1's inputs, then three pairs, each launching
   R1 24 times, the sweep once and nothing else; the 9 Eigen metrics,
   finite; ms per pair with the flow / pose / depth split, peak memory;
25. R1 against its plain version on phase 24's pyramid and each of its 24
   coordinate maps, bf16 and float32 out, on a tail block (the first 7332
   queries) and at the clip's bounds and off the frame, bit for bit at
   every level; per pair its device,
   CUDA-graph and events ms, the byte bound and the bound at the 32-byte
   sectors the tap rows touch, plain ms and `F.grid_sample` over the four
   levels (upstream RAFT's lookup) as the yardstick; with `--old-raft PATH`
   that source's R1 bit for bit and in turns (old, new, new, old) by CUDA
   graph, on the device and by events;
26. slice 15's training path through `cli.main --train-flow --override
   flow.estimator=RAFT` on a 36-pair KITTI 2015 flow tree at 375x1242
   (padded to /8), 256x768 crops, b = 4, bf16: three untimed steps (the
   first records R2's inputs) and six timed ones, each launching R1 and R2
   12 times and nothing else, every RAFT parameter moved; median, spread,
   stage split and peak memory; the validation's EPE and Fl-all (R1 24
   times a pair); `--pretrained-flow` into SFMNet;
27. R2 against its plain version on phase 26's captured coordinates,
   pyramid and gradients, in bf16 and float32, unit-scale, at the clip's
   bounds and on a tail block, each adding into accumulators that hold
   random values: the accumulators bit for bit, d coords to 1e-5 of its
   largest; the step's whole backward (one zero fill, the 12 launches last
   iteration first) bit for bit the dense plain gradients added in bf16;
   per step the launches'
   and the whole backward's device, CUDA-graph and events ms, the bound of
   this interface and of the dense one, plain ms and
   `grid_sampler_2d_backward` over the four levels (upstream's gradient)
   as the yardstick; with `--old-raft PATH` that source's whole backward
   as autograd ran it (12 dense launches, each level's bf16 `add_` after
   the first) bit for bit the new accumulators and in turns. The RAFT
   phases' seconds are printed;
28. fault C.2's route: `cli.main -v --override pose.estimator=GT
   use_gt_pose=True` on a rendered 370x1224 tree (no pose net, no flow
   run, PSNet on the ground-truth pose, bf16), each pair launching the
   sweep once and nothing else; the 9 Eigen metrics, finite;
29. PANet and REGNet (slice 17) on the card against the CPU: a 128x128
   SFMNet in float32 with `depth.estimator` PANET, then REGNET, on a given
   pose, depth to 1e-3 relative;
30. `cli.main -v --override depth.estimator=PANET` on a rendered 370x1224
   tree (DICL flow, the 512x5 RANSAC, 384x1280, nlabel 128, 9 pose scales
   in one sweep, bf16): a warm-up and three pairs, each launching the
   displacement volume 5 times and the sweep once; the 9 Eigen metrics,
   finite; stage ms by CUDA events, peak memory;
31. the same with `depth.estimator=REGNET` (125 poses): K1 once a pair
   instead of the sweep; the warm-up records K1's inputs;
32. REGNet's depth-training step through `cli.main` (b = 4, 256x768, bf16,
   DICL frozen): a warm-up step recording K1's and K2's inputs, then three
   steps launching the displacement volume 5 times, K1 and K2 once each,
   with finite losses and REGNet's parameters moved; validation, peak
   memory;
33. K1 bit for bit and K2 to 1e-5 of its largest plus one bf16 ulp against
   their plain versions on phases 31's and 32's inputs, with device,
   CUDA-graph and events ms, the bound, the plain ms and the composition
   they replaced (grid_sample + product + mean, and its autograd, a pose at
   a time). The script's total seconds are printed.

`python3 chip_smoke.py --save-sweep-inputs PATH` also writes the sweep
backward's depths, M and K t from slice 5 (a few hundred floats) to PATH,
for `b1_compare.py --pose PATH`; `--save-disp-inputs PATH` the
displacement volume's inputs of slice 1's pair and a training step, for
`b1_compare.py --volume --inputs PATH`; `--old-b1 PATH` names the earlier
source phases 13, 14 and 17 compare with, `--old-b2 PATH` the earlier
`local_corr.cu` (with its NHWC warped correlation) phases 7 and 19 do,
`--old-b2-backward PATH` the earlier `warped_corr_backward.cu` phase 22
does, `--old-raft PATH` the earlier `raft_lookup.cu` phases 25 and 27 do.

The line before the last is the kernel table as one JSON object (fourteen
kernels, with launches on each of fifteen paths); the last
is {"ok": true, "device": {...}}. Without a CUDA device, or without the
port's package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
PKG = "deep_sfm_revisited_tpu_torch"

# bench.py's protocol: KITTI 370x1224 padded to /128, b = 1, its K and overrides
B, H, W = 1, 384, 1280
PAIRS = 3
K_KITTI = [[718.856, 0.0, 607.19], [0.0, 718.856, 185.2], [0.0, 0.0, 1.0]]
BENCH_OVERRIDES = {"pose.num_hypotheses": 512, "pose.ransac_iter": 5,
                   "pose.num_correspondences": 1024, "pose.polish_iters": 5}
B1_PER_PAIR = 0  # the generic gather: PWC-DC's warps are fused into B2, DICL's into its volume
DISP_PER_PAIR = 5  # the displacement volume: DICL's levels 6..2, warp included
SWEEP_PER_PAIR = 1  # the sweep kernel: PSNet's cost volume (one target)
B2_PER_PAIR = 1  # PWC-DC's correlation at level 6 (no flow to warp with)
WARPED_PER_PAIR = 4  # PWC-DC's warped correlation at levels 5..2 (warp and correlation fused)
EIGEN_KEYS = {"abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3", "l1_inv", "sc_inv"}

# the small-input reference: two-stage vote on, float64 candidates so the
# vote is reproducible across devices
SMALL = {"depth.nlabel": 8, "pose.num_hypotheses": 16, "pose.ransac_iter": 1,
         "pose.num_correspondences": 128, "pose.score_subset": 32,
         "pose.score_topk": 64, "pose.polish_iters": 5, "pose.solve_dtype": "float64"}

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores, dense bfloat16 FLOP/s on the tensor cores
# (bfloat16 products, float32 sums)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
B1_FLOPS_PER_OUTPUT = 10  # 6 tap products, 3 sums, the validity product
SWEEP_FLOPS_PER_SAMPLE = 8  # ray d + K t (3 products, 3 sums) and the 2 divisions

B1_SOURCE = f"{PKG}/csrc/sweep_warp.cu"
B1_REPLACES = "deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py:145"
B2_SOURCE = f"{PKG}/csrc/local_corr.cu"
B2_REPLACES = "deep_sfm_revisited_tpu/ops/pallas/local_corr.py:80"
B2_MD = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not bool(ok):
        raise AssertionError(msg)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of `fn` in ms, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_setup(*kernels) -> str:
    """Card line, TF32 off, and each given kernel module's source built."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"setup: torch {torch.__version__} cuda {torch.version.cuda}; "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    builds = [b for k in kernels for b in (k.BUILDS if hasattr(k, "BUILDS") else (k.KERNEL,))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc per source, together
        for f in [pool.submit(b.build) for b in builds]:
            f.result()
    log(f"setup: {', '.join(b.source for b in builds)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    for b in builds:
        for line in b.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {b.source}: {line.strip()}")
    return card


def phase_pose(dev) -> None:
    from deep_sfm_revisited_tpu_torch.ops import camera, essential, flow_ops, rotations

    f64 = torch.float64
    b, h, w, f = 1, 96, 128, 80.0
    K = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], dtype=f64,
                     device=dev).expand(b, 3, 3)
    K_inv = torch.linalg.inv(K)
    R = rotations.angle_to_matrix(torch.tensor([0.02, -0.03, 0.01], dtype=f64, device=dev))
    t = torch.tensor([0.4, 0.1, 0.2], dtype=f64, device=dev)
    t = t / torch.linalg.vector_norm(t)
    pose = torch.cat([R, t[:, None]], dim=1)[None]
    g = torch.Generator(device=dev).manual_seed(3)
    depth = 5.0 + 3.0 * torch.rand((b, h, w), generator=g, dtype=f64, device=dev)
    flow = camera.pose2flow(depth, pose, K, K_inv)
    kw = dict(num_hypotheses=128, ransac_iter=1, threshold=1e-4, polish=True, generator=g)

    x1, x2 = flow_ops.sample_correspondences(flow, K_inv, 512, margin=10)
    out = essential.ransac_pose(x1[0], x2[0], **kw)
    r_err = float(rotations.rotation_angular_error(out["P"][:, :3], R))
    t_err = float(torch.arccos(torch.clamp(torch.dot(out["P"][:, 3], t), -1.0, 1.0)))
    log(f"pose: rotation error {r_err:.3e} rad, translation direction error "
        f"{t_err:.3e} rad, {int(out['inliers'])}/512 inliers")
    check(r_err < 2e-3, f"rotation error {r_err} rad >= 2e-3")
    check(t_err < 2e-2, f"translation direction error {t_err} rad >= 2e-2")

    x0, _ = flow_ops.sample_correspondences(torch.zeros_like(flow), K_inv, 512, margin=10)
    probe = essential.ransac_pose(x0[0], x0[0], **kw)
    check(torch.isfinite(probe["P"]).all(), "zero-parallax probe: non-finite P")
    t_norm = float(torch.linalg.vector_norm(probe["P"][:, 3]))
    check(abs(t_norm - 1.0) < 1e-9, f"zero-parallax probe: |t| = {t_norm}")
    log("pose: zero-parallax probe gives a finite P with unit t")

    # the engine on the card against the engine on the CPU, same inputs and
    # minimal samples, on the scene with noise and 20% outliers, two-stage
    # vote on, both candidate paths. Well posed, so the vote is stable:
    # equal inlier counts, P to 1e-5 (f32 candidates; f64 agrees to ~1e-11).
    gc = torch.Generator().manual_seed(5)
    x1, x2 = x1.cpu(), x2.cpu() + 1e-5 * torch.randn(x2.shape, generator=gc, dtype=f64)
    bad = torch.rand(x2.shape[:2], generator=gc) < 0.2
    x2 = torch.where(bad[..., None], (torch.rand(x2.shape, generator=gc, dtype=f64) - 0.5) * 1.2, x2)
    idx = torch.randint(0, 512, (1, 128, 5), generator=gc)
    for solve in (torch.float64, torch.float32):
        kw = dict(num_hypotheses=128, ransac_iter=1, threshold=1e-4, polish=True,
                  polish_iters=5, solve_dtype=solve, score_subset=128, score_topk=512)
        on_cpu = essential.ransac_pose(x1, x2, sample_idx=idx, **kw)
        on_card = essential.ransac_pose(x1.to(dev), x2.to(dev), sample_idx=idx.to(dev), **kw)
        n = (int(on_card["inliers"][0]), int(on_cpu["inliers"][0]))
        p_err = float((on_card["P"].cpu() - on_cpu["P"]).abs().max())
        log(f"pose: card vs CPU, {str(solve)[6:]} candidates: inliers {n[0]} vs {n[1]}, "
            f"P max |card - cpu| {p_err:.3e}")
        check(n[0] == n[1], f"pose card vs CPU ({solve}): inliers {n[0]} vs {n[1]}")
        check(p_err <= 1e-5, f"pose card vs CPU ({solve}): P differs by {p_err}")


def phase_small_reference(dev, flow: str) -> None:
    """The port on the card against the port on the CPU: same weights, inputs and draws.

    Flow to 1e-3 px and depth to 1e-3 relative: float32 convolutions sum in
    another order in cuDNN than on the CPU (TF32 off). The RANSAC problem a
    random-weight flow poses is degenerate: ulp-level differences move
    points across the Sampson threshold and crown other candidates on the
    two devices. So the pose here is only held to be a proper rotation with
    a unit translation, and the card's depth to the CPU's depth at the
    card's own pose; phase 2 holds the pose engine card-to-CPU on a
    well-posed scene.
    """
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet

    cfg = SfMConfig.kitti().override(**SMALL, **{"flow.estimator": flow})
    gpu = SFMNet(cfg, device=dev, seed=1)
    cpu = SFMNet(cfg, device="cpu", seed=1)
    g = torch.Generator().manual_seed(7)
    h = w = 128
    ref = torch.rand((1, h, w, 3), generator=g) * 2 - 1
    tgt = torch.roll(ref, (1, 3), dims=(1, 2)) + 0.05 * torch.randn((1, h, w, 3), generator=g)
    K = torch.tensor([[[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]]])
    a = 0.03
    pose_gt = torch.tensor([[[math.cos(a), 0, math.sin(a), 0.2], [0, 1, 0, 0.0],
                             [-math.sin(a), 0, math.cos(a), 0.95]]])
    # the entropy sampler's 4x candidate grid; PWC-DC gives no confidence,
    # so its sampler takes the uniform path over a 1x grid
    n_cand = cfg.pose.num_correspondences * (4 if flow == "DICL" else 1)
    draws = {"jitter": torch.rand((1, n_cand, 2), generator=g) - 0.5,
             "gumbel_u": torch.rand((1, n_cand), generator=g) * (1 - 1e-12) + 1e-12,
             "sample_idx": torch.randint(0, cfg.pose.num_correspondences,
                                         (1, cfg.pose.num_hypotheses, 5), generator=g)}

    def on_card(**kw):
        out = gpu(ref.to(dev), tgt.to(dev), K.to(dev), **kw)
        return {k: v.cpu() for k, v in out.items() if v is not None}

    def rel(a_, b_):
        return float(((a_ - b_).abs() / b_.abs()).max())

    g_on = on_card(draws={k: v.to(dev) for k, v in draws.items()})
    c_on = cpu(ref, tgt, K, draws=draws)
    c_at = cpu(ref, tgt, K, pose_gt=g_on["pose"], use_gt_pose=True)
    g_gt = on_card(pose_gt=pose_gt.to(dev), use_gt_pose=True)
    c_gt = cpu(ref, tgt, K, pose_gt=pose_gt, use_gt_pose=True)
    for out in (g_on, g_gt):
        for key in ("flow", "pose", "depth_init", "depth"):
            check(torch.isfinite(out[key]).all(), f"small reference: non-finite {key}")
    flow_err = float((g_on["flow"] - c_on["flow"]).abs().max())
    pose_err = float((g_on["pose"] - c_on["pose"]).abs().max())
    d_on = max(rel(g_on[k], c_at[k]) for k in ("depth_init", "depth"))
    d_gt = max(rel(g_gt[k], c_gt[k]) for k in ("depth_init", "depth"))
    n_in = (int(g_on["inliers"][0]), int(c_on["inliers"][0]))
    what = f"small reference {flow}"
    counts = (f"confident candidates {int(g_on['num_matches'][0])} vs "
              f"{int(c_on['num_matches'][0])}; " if "num_matches" in g_on else "")
    log(f"{what}: flow max |card - cpu| {flow_err:.3e} px; {counts}"
        f"inliers {n_in[0]} vs {n_in[1]}; pose max |card - cpu| {pose_err:.3e}; depth "
        f"relative {d_on:.3e} (card's pose), {d_gt:.3e} (given pose)")
    check(flow_err <= 1e-3, f"{what}: flow differs by {flow_err} px")
    c_keys = {k for k, v in c_on.items() if v is not None}
    check(g_on.keys() == c_keys, f"{what}: outputs {sorted(g_on)} vs {sorted(c_keys)}")
    if "num_matches" in g_on:
        check(torch.equal(g_on["num_matches"], c_on["num_matches"]),
              f"{what}: confident-candidate counts differ")
    _check_pose(g_on["pose"], what)
    check(d_on <= 1e-3, f"{what}: depth at the card's pose differs by {d_on}")
    check(d_gt <= 1e-3, f"{what}: depth at the given pose differs by {d_gt}")


class StageTimer:
    """CUDA events at the entry and exit of the flow and depth networks;
    the pose stage is the time between them (sampler + RANSAC)."""

    def __init__(self, model):
        self.events = {}
        for name, mod in (("flow", model.flow_estimator), ("depth", model.depth_estimator)):
            mod.register_forward_pre_hook(lambda m, a, n=name: self._mark(f"{n}_start"))
            mod.register_forward_hook(lambda m, a, o, n=name: self._mark(f"{n}_end"))

    def _mark(self, key):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[key] = ev

    def stages_ms(self):
        e = self.events
        return {"flow": e["flow_start"].elapsed_time(e["flow_end"]),
                "pose": e["flow_end"].elapsed_time(e["depth_start"]),
                "depth": e["depth_start"].elapsed_time(e["depth_end"])}


def _check_pose(pose, what):
    check(tuple(pose.shape) == (B, 3, 4) and torch.isfinite(pose).all(),
          f"{what}: pose {tuple(pose.shape)} or not finite")
    t_norm = torch.linalg.vector_norm(pose[:, :, 3].double(), dim=-1)
    check(torch.allclose(t_norm, torch.ones_like(t_norm), atol=1e-5),
          f"{what}: |t| = {t_norm.tolist()}")
    R = pose[:, :, :3].double()
    check(torch.allclose(R @ R.transpose(-1, -2), torch.eye(3, dtype=R.dtype, device=R.device),
                         atol=1e-4), f"{what}: rotation not orthonormal")


def _check_pair(out, i):
    depth = out["depth"]
    check(tuple(depth.shape) == (B, H, W), f"pair {i}: depth shape {tuple(depth.shape)}")
    check(torch.isfinite(depth).all(), f"pair {i}: non-finite depth")
    _check_pose(out["pose"], f"pair {i}")


def _launches(*kernels):
    return tuple(k.launches for k in kernels)


@contextlib.contextmanager
def recording_displacement(sweep_warp):
    """Within the block, every call of B1's displacement-volume wrapper
    records copies of its inputs (x, y, flow or None, md) in the list the
    block binds, then launches."""
    calls, launch = [], sweep_warp.displacement_volume_cuda

    def record(x, y, flow, md):
        calls.append((x.clone(), y.clone(), None if flow is None else flow.clone(), md))
        return launch(x, y, flow, md)

    sweep_warp.displacement_volume_cuda = record
    try:
        yield calls
    finally:
        sweep_warp.displacement_volume_cuda = launch


def _disp_shapes(calls):
    return [tuple(x.shape) + ("flow" if f is not None else "no flow",) for x, _, f, _ in calls]


def phase_main_path(dev, sweep_warp):
    """Warm-up pair (records the inputs of B1's sweep and displacement-volume
    kernels), then PAIRS counted, timed pairs, each of which must launch the
    displacement volume 5 times, the sweep once and the generic gather no
    time. Returns (sweep launches, displacement-volume launches, sweep
    inputs, displacement-volume inputs)."""
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet

    cfg = SfMConfig.kitti(nlabel=128).override(**BENCH_OVERRIDES)
    model = SFMNet(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(4)
    refs = torch.rand((PAIRS + 1, B, H, W, 3), generator=g, device=dev) * 2 - 1
    tgts = torch.roll(refs, 3, dims=3)          # bench.py's target
    K = torch.tensor(K_KITTI, device=dev).expand(B, 3, 3)
    timer = StageTimer(model)

    cap_sweep = []
    sweep = sweep_warp.plane_sweep_volume_cuda

    def recording_sweep(*args):
        cap_sweep.append(tuple(a.clone() for a in args))
        return sweep(*args)

    sweep_warp.plane_sweep_volume_cuda = recording_sweep
    try:
        with recording_displacement(sweep_warp) as cap_disp:
            t0 = time.perf_counter()
            _check_pair(model(refs[0], tgts[0], K,
                              generator=torch.Generator(device=dev).manual_seed(100)), 0)
            torch.cuda.synchronize()
    finally:
        sweep_warp.plane_sweep_volume_cuda = sweep
    log(f"main path: warm-up pair {1e3 * (time.perf_counter() - t0):.1f} ms, "
        f"displacement-volume inputs recorded: {_disp_shapes(cap_disp)}, sweep inputs: "
        f"{[tuple(a[0].shape) + (len(a[2]),) for a in cap_sweep]}")
    check((len(cap_disp), len(cap_sweep)) == (DISP_PER_PAIR, SWEEP_PER_PAIR),
          f"warm-up launched the displacement volume {len(cap_disp)}, the sweep "
          f"{len(cap_sweep)} times")

    torch.cuda.reset_peak_memory_stats()
    counters = (sweep_warp.KERNEL, sweep_warp.VOLUME, sweep_warp.DISPLACEMENT)
    per_pair = (0, SWEEP_PER_PAIR, DISP_PER_PAIR)
    for k in counters:
        k.launches = 0
    rows = []
    for i in range(1, PAIRS + 1):
        before = _launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(refs[i], tgts[i], K,
                    generator=torch.Generator(device=dev).manual_seed(100 + i))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n = tuple(a - b for a, b in zip(_launches(*counters), before))
        _check_pair(out, i)
        check(n == per_pair, f"pair {i}: gather, sweep, displacement volume launched {n} "
              f"times, expected {per_pair}")
        rows.append(dict(ms=ms, **timer.stages_ms(), inliers=int(out["inliers"][0]),
                         num_matches=int(out["num_matches"][0])))
        log(f"main path: pair {i}: {ms:.1f} ms (flow {rows[-1]['flow']:.1f}, pose "
            f"{rows[-1]['pose']:.1f}, depth {rows[-1]['depth']:.1f} ms device); "
            f"inliers {rows[-1]['inliers']}/{cfg.pose.num_correspondences}, confident candidates "
            f"{rows[-1]['num_matches']}, gather, sweep, displacement volume launches {n}")
    launches = _launches(*counters)
    check(launches == tuple(PAIRS * n for n in per_pair),
          f"gather, sweep, displacement volume launched {launches} times in the main path")
    mean = {k: sum(r[k] for r in rows) / PAIRS for k in ("ms", "flow", "pose", "depth")}
    log(f"main path: mean over {PAIRS} pairs: {mean['ms']:.2f} ms/pair "
        f"({1e3 / mean['ms']:.3f} pairs/s); stages flow {mean['flow']:.2f}, pose "
        f"{mean['pose']:.2f}, depth {mean['depth']:.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("main path rows: " + json.dumps(rows))
    return launches[1], launches[2], cap_sweep, cap_disp


def _with_edges(coords, h, w):
    """A copy of coords whose first row of queries holds the edge cases:
    behind-camera sentinels (2w, 2h), exact borders and points just out of
    range. Returns (coords, mask of the queries that must give zero)."""
    c = coords.clone()
    flat = c.reshape(c.shape[0], -1, 2)
    cases = torch.tensor([[2.0 * w, 2.0 * h], [0.0, 0.0], [w - 1.0, h - 1.0],
                          [w - 1.0, 0.5], [-1e-3, 1.0], [1.0, h - 1.0 + 1e-3],
                          [w - 0.5, 2.0], [-2.0 * w, -2.0 * h]], device=c.device)
    flat[:, :len(cases)] = cases
    zero = torch.zeros(flat.shape[:2], dtype=torch.bool, device=c.device)
    zero[:, [0, 4, 5, 6, 7]] = True
    return c, zero


def phase_cli_pwc(dev, sweep_warp, local_corr):
    """Slice 2 through `cli.main -v` on a rendered golden KITTI raw tree.

    `SFMNet.forward` is wrapped for the run: it times each pair (host clock
    around the forward and a synchronize; stage times by CUDA events),
    counts each kernel's launches per pair, and on the warm-up pair records
    the inputs of B1's sweep kernel, of B2 (level 6) and of the warped
    correlation (levels 5..2). Returns the launch counts over the three
    pairs after the warm-up (gather, sweep, B2, B1's displacement volume and
    the warped correlation; PWC-DC launches neither the gather nor the
    volume) and the inputs (warped correlation, sweep, B2).
    """
    from deep_sfm_revisited_tpu_torch import cli
    from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_raw_tree
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet

    rows, cap_w, cap_sweep, cap2, timer = [], [], [], [], []
    real_forward, launch_w, launch2 = (SFMNet.forward, local_corr.warped_correlation_cuda,
                                       local_corr.local_correlation_cuda)
    sweep = sweep_warp.plane_sweep_volume_cuda
    counters = (sweep_warp.KERNEL, sweep_warp.VOLUME, local_corr.KERNEL,
                sweep_warp.DISPLACEMENT, local_corr.WARPED)
    per_pair = (B1_PER_PAIR, SWEEP_PER_PAIR, B2_PER_PAIR, 0, WARPED_PER_PAIR)

    def record_w(f1, f2, flow, scale, md):
        cap_w.append((f1.clone(), f2.clone(), flow.clone(), scale, md))
        return launch_w(f1, f2, flow, scale, md)

    def record_sweep(*args):
        cap_sweep.append(tuple(a.clone() for a in args))
        return sweep(*args)

    def record2(f0, f1, md):
        cap2.append((f0.clone(), f1.clone()))
        return launch2(f0, f1, md)

    def timed_forward(model, *args, **kw):
        warm = not timer
        if warm:
            timer.append(StageTimer(model))
            local_corr.warped_correlation_cuda, local_corr.local_correlation_cuda = record_w, record2
            sweep_warp.plane_sweep_volume_cuda = record_sweep
        before = _launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = real_forward(model, *args, **kw)
            torch.cuda.synchronize()
        finally:
            local_corr.warped_correlation_cuda, local_corr.local_correlation_cuda = launch_w, launch2
            sweep_warp.plane_sweep_volume_cuda = sweep
        ms = 1e3 * (time.perf_counter() - t0)
        n = tuple(a - b for a, b in zip(_launches(*counters), before))
        i = len(rows) + (0 if warm else 1)
        _check_pair(out, i)
        check(out["num_matches"] is None, f"PWC pair {i}: the sampler reported confidences")
        check(n == per_pair, f"PWC pair {i}: gather, sweep, B2, displacement volume, warped "
              f"correlation launched {n} times, expected {per_pair}")
        if warm:
            for k in counters:
                k.launches = 0
            log(f"cli PWC: warm-up pair {ms:.1f} ms; warped correlation inputs "
                f"{_warped_inputs_desc(cap_w)}, "
                f"sweep inputs {[tuple(a[0].shape) + (len(a[2]),) for a in cap_sweep]}, B2 "
                f"inputs {[tuple(f.shape) for f, _ in cap2]}")
        else:
            rows.append(dict(ms=ms, **timer[0].stages_ms(), inliers=int(out["inliers"][0])))
            log(f"cli PWC: pair {i}: {ms:.1f} ms (flow {rows[-1]['flow']:.1f}, pose "
                f"{rows[-1]['pose']:.1f}, depth {rows[-1]['depth']:.1f} ms device); inliers "
                f"{rows[-1]['inliers']}/{BENCH_OVERRIDES['pose.num_correspondences']}; "
                f"gather, sweep, B2, displacement volume, warped correlation launches {n}")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti_raw"
        t0 = time.perf_counter()
        write_kitti_raw_tree(root, n_frames=PAIRS + 2, hw=(370, 1224),
                             focal=K_KITTI[0][0], n_test=PAIRS + 1)
        log(f"cli PWC: golden tree of {PAIRS + 2} 370x1224 frames rendered in "
            f"{time.perf_counter() - t0:.2f} s")
        argv = ["--data", root, "--cfg", "kitti", "-v", "--gt-depth-dir", f"{root}/gt_depth",
                "--out", f"{tmp}/out", "--workers", "4", "--override", "flow.estimator=PWC",
                *[f"{k}={v}" for k, v in BENCH_OVERRIDES.items()]]
        log("cli PWC: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        torch.cuda.reset_peak_memory_stats()
        for k in counters:
            k.launches = 0
        SFMNet.forward = timed_forward
        try:
            t0 = time.perf_counter()
            results = cli.main(argv)
            wall = time.perf_counter() - t0
        finally:
            SFMNet.forward = real_forward
        launches = _launches(*counters)
    check(len(rows) == PAIRS, f"cli PWC: {len(rows)} test pairs after the warm-up, expected {PAIRS}")
    check(launches == tuple(PAIRS * n for n in per_pair),
          f"cli PWC: gather, sweep, B2, displacement volume, warped correlation launched "
          f"{launches} times in the main path")
    check(set(results) == EIGEN_KEYS, f"cli PWC: metrics {sorted(results)}")
    check(all(math.isfinite(v) for v in results.values()), f"cli PWC: metrics {results}")
    mean = {k: sum(r[k] for r in rows) / PAIRS for k in ("ms", "flow", "pose", "depth")}
    log(f"cli PWC: metrics {json.dumps(results)}")
    log(f"cli PWC: mean over {PAIRS} pairs: {mean['ms']:.2f} ms/pair ({1e3 / mean['ms']:.3f} "
        f"pairs/s); stages flow {mean['flow']:.2f}, pose {mean['pose']:.2f}, depth "
        f"{mean['depth']:.2f} ms; cli.main {wall:.2f} s for {PAIRS + 1} pairs; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("cli PWC rows: " + json.dumps(rows))
    return launches, (cap_w, cap_sweep, cap2)


def _warp_coords(f2, flow, scale):
    """The coordinates PWC-DC's warp samples f2 (B, H, W, C) at: grid +
    flow * scale, (B, H, W, 2), as `warp_flow` builds them."""
    from deep_sfm_revisited_tpu_torch.ops.camera import pixel_grid

    B_, H_, W_, _ = f2.shape
    grid = pixel_grid(H_, W_, torch.float32, f2.device)[:2]
    return (grid[None] + flow * scale).permute(0, 2, 3, 1).contiguous()


def _warped_inputs_desc(cap_w):
    """(f2's shape, its dtype, the flow's dtype, the scale) of each recorded
    warped correlation."""
    return [(tuple(f.shape), str(f.dtype)[6:], str(fl.dtype)[6:], sc) for _, f, fl, sc, _ in cap_w]


def pwc_warp_inputs(cap_w, cap2, sweep_warp):
    """From the warped correlation's captured inputs (NCHW), what the
    composition it replaced gave B1's gather (f2 NHWC, the coordinates) and
    B2 (f1 and the warped f2 NHWC in float32, through the gather), levels
    5..2, after B2's own level-6 inputs: phases 6 and 7 hold both kernels
    on them."""
    gathers = [(f2.permute(0, 2, 3, 1).contiguous(), flow.float(), sc)
               for _, f2, flow, sc, _ in cap_w]
    gathers = [(f2, _warp_coords(f2, flow, sc)) for f2, flow, sc in gathers]
    corr = list(cap2) + [(f1.permute(0, 2, 3, 1).float().contiguous(),
                          sweep_warp.bilinear_sample_cuda(f2, c).float().contiguous())
                         for (f1, _, _, _, _), (f2, c) in zip(cap_w, gathers)]
    return gathers, corr


def device_profile(fn, reps: int = 20) -> dict:
    """{name: [ms, count]} per call of `fn` of every kernel, copy and fill
    that `reps` calls put on the card, from a torch.profiler trace (no host
    launch cost). Late in a long process a trace now and then lacks some of
    its events, or all of them: `_full_profile` and `device_ms` refuse such
    traces."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0.0])
            row[0] += e.time_range.elapsed_us() / reps / 1e3
            row[1] += 1 / reps
    return by_name


def device_ms(fn, kernel_name: str, reps: int = 20, tries: int = 10) -> float | None:
    """Device time in ms per call of `fn` of the kernels whose names contain
    `kernel_name`, from a trace `_full_profile` accepts; None if none is."""
    return _profile_sums(_full_profile(fn, reps=reps, tries=tries, name=kernel_name))[0]


def _edged_features(f1):
    """A copy of f1 whose frame border (first and last row and column)
    holds values far above the rest, so a read across the border would
    show."""
    e = f1.clone()
    e[:, [0, -1]] = 100.0
    e[:, :, [0, -1]] = 100.0
    return e


def _outside_mask(h, w, md, device):
    """(H, W, (2md+1)^2) True where (y+dy, x+dx) leaves the frame."""
    d = torch.arange(-md, md + 1, device=device)
    dy, dx = d.repeat_interleave(2 * md + 1), d.repeat(2 * md + 1)
    ys = torch.arange(h, device=device)[:, None, None] + dy
    xs = torch.arange(w, device=device)[None, :, None] + dx
    return (ys < 0) | (ys >= h) | (xs < 0) | (xs >= w)


def phase_b2(captured, local_corr, correlation):
    """B2 vs its plain version at slice 2's inputs, on a border-edged copy
    and on two odd shapes; bit-identical relaunches; mapping, times and
    bounds per call.

    Tolerance: float32 sums of <= 196 products in another order (the
    kernel's fmaf chains, split across a cluster's blocks, against torch's
    reduction), |kernel - plain| <= 1e-5 max|plain| + 1e-6; displacements
    that leave the frame give exactly zero."""
    g = torch.Generator(device="cuda").manual_seed(11)
    odd = [tuple(torch.randn(shape, device="cuda", generator=g) for _ in range(2))
           for shape in ((2, 13, 27, 40), (1, 5, 7, 3))]
    calls, max_err = [], 0.0
    for idx, (f0, f1) in enumerate(list(captured) + odd):
        _, h, w, c = f0.shape
        name = f"pwc_corr_level{6 - idx}" if idx < len(captured) else "odd_shape"
        p = local_corr.plan(*f0.shape, B2_MD)
        for what, a, b in (("main path", f0, f1), ("edged", f0, _edged_features(f1))):
            got = local_corr.local_correlation_cuda(a, b, B2_MD)
            again = local_corr.local_correlation_cuda(a, b, B2_MD)
            ref = correlation.local_correlation_plain(a, b, B2_MD)
            check(torch.equal(got, again), f"B2 {name} {what}: two launches differ")
            err = float((got - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max()) + 1e-6
            max_err = max(max_err, err)
            check(err <= tol, f"B2 {name} {what}: max |kernel - plain| = {err} > {tol}")
            outside = _outside_mask(h, w, B2_MD, got.device).expand_as(got)
            check((got[outside] == 0).all(), f"B2 {name} {what}: nonzero outside the frame")
        mapping = (f"px {p.px}, cluster {p.cluster}, grid {p.grid}, block {p.block}, "
                   f"{p.warps} warps")
        if idx >= len(captured):
            log(f"B2 odd shape {tuple(f0.shape)}: max |kernel - plain| {err:.3e}, two "
                f"launches bit-identical; mapping {mapping}")
            continue
        ms = cuda_ms(lambda: local_corr.local_correlation_cuda(f0, f1, B2_MD), reps=50)
        dev_ms = device_ms(lambda: local_corr.local_correlation_cuda(f0, f1, B2_MD),
                           "local_corr_kernel")
        plain_ms = cuda_ms(lambda: correlation.local_correlation_plain(f0, f1, B2_MD), reps=5,
                           warmup=1)
        s2 = (2 * B2_MD + 1) ** 2
        nbytes = 4 * (f0.numel() + f1.numel() + f0.numel() // c * s2)
        flops = (2 * c + 1) * s2 * (f0.numel() // c)     # c products + c sums, one division
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        calls.append(dict(name=name, f0=list(f0.shape), md=B2_MD, ms=ms, device_ms=dev_ms,
                          plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                          bound_by="bytes" if t_bytes >= t_ops else "operations",
                          bound_share=None if dev_ms is None else bound / dev_ms,
                          bytes=nbytes, flops=flops,
                          mapping=dict(px=p.px, cluster=p.cluster, grid=list(p.grid),
                                       block=list(p.block), warps=p.warps)))
        share = "not measured" if dev_ms is None else f"{100 * bound / dev_ms:.1f}%"
        log(f"B2 {name}: f0/f1 {tuple(f0.shape)} float32: device "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}, events {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({calls[-1]['bound_by']}, "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP), share of bound {share}; "
            f"mapping {mapping}")
    return calls, max_err


WARPED_SOURCE = f"{PKG}/csrc/warped_corr.cu"
WARPED_FUSES = ("deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py:145 (the gather of PWC-DC's "
                "flow warps, deep_sfm_revisited_tpu/models/pwcnet.py:125)")


def _off_frame(flow, scale):
    """A copy of the flow whose last columns' samples land a frame width to
    the right and whose first rows' samples land above the frame."""
    off = flow.clone()
    W_, H_ = flow.shape[-1], flow.shape[-2]
    off[:, 0, :, -max(W_ // 8, 1):] += 2.0 * W_ / scale
    off[:, 1, : max(H_ // 8, 1)] -= 1.5 * H_ / scale
    return off


def graph_ms(call, reps: int = 20) -> float:
    """Device ms per call of `call`: `reps` calls captured in one CUDA graph,
    replayed between CUDA events (no host cost per call; the graph's gaps
    between kernels included). Median of 5 replays. Unlike a profiler trace
    it cannot lose events late in a long process."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            call()
    graph.replay()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)[2]


def graph_kernels(call) -> int | None:
    """Kernels one call of `call` launches: the kernel nodes of a CUDA graph
    that captures it, read from the graph's debug dump (DOT). Unlike a
    profiler trace it cannot lose events late in a long process. None where
    the dump shows no node."""
    import re

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    try:   # kept, so that the dump has a graph to print (PyTorch 2.6 on)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:   # earlier PyTorch keeps it in debug mode
        graph = torch.cuda.CUDAGraph()
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        call()
    with tempfile.TemporaryDirectory() as tmp:
        dot = Path(tmp) / "graph.dot"
        graph.debug_dump(str(dot))
        text = dot.read_text() if dot.exists() else ""
    del graph
    # a node's definition runs from its name and "[" to the next "];"
    nodes = re.findall(r'"graph_\d+_node_\d+"\s*\[(.*?)\];', text, flags=re.S)
    if not nodes:
        return None
    return sum(1 for n in nodes if re.search(r"kernel", n, flags=re.I))


def old_warped_correlation(path: Path, local_corr):
    """PWC-DC's warped correlation of an earlier `local_corr.cu` whose entry
    point takes NHWC float32 f1, NHWC f2 of its dtype and a float32 flow
    and writes NHWC float32 (`..., int md, int px, int cluster, int dtype,
    void* stream`), with B2's mapping (`local_corr.plan`), built by
    `ops/cuda/build.py` beside the current sources and called through its
    plain C entry point with ctypes. Returns (kernel, span): the kernel on
    NHWC inputs, and the span PWC-DC ran around it on NCHW features of the
    network's dtype (the permutes and copies in, the flow's float32 cast
    and copy, the kernel, the permute and cast back)."""
    import ctypes

    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    check("int md, int px, int cluster, int dtype, void* stream" in path.read_text(),
          f"{path} has no NHWC warped correlation")

    class OldWarped(CudaKernel):
        source = str(path.resolve())   # an absolute path replaces csrc/

        def _bind(self, lib):
            fn = lib.dsfm_warped_correlation
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p]
                           + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

        def __call__(self, f1, f2, flow, scale, md):
            B_, H_, W_, C_ = f1.shape
            p = local_corr.plan(B_, H_, W_, C_, md)
            out = torch.empty((B_, H_, W_, (2 * md + 1) ** 2), device=f1.device)
            err = self.build().dsfm_warped_correlation(
                f1.data_ptr(), f2.data_ptr(), flow.data_ptr(), ctypes.c_float(scale),
                out.data_ptr(), B_, H_, W_, C_, md, p.px, p.cluster,
                {torch.float32: 0, torch.bfloat16: 1}[f2.dtype],
                torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{path}'s warped correlation launch failed: cudaError {err}")
            return out

    old = OldWarped()

    def span(f1, f2, up_flow, scale, md):   # PWC-DC's _warped_correlate and dispatcher then
        corr = old(f1.permute(0, 2, 3, 1).float().contiguous(),
                   f2.permute(0, 2, 3, 1).contiguous(), up_flow.float().contiguous(), scale, md)
        return corr.permute(0, 3, 1, 2).to(f1.dtype)

    return old, span


def warped_graph_check(cap_w, level6, local_corr) -> dict:
    """PWC-DC's five correlations of a pair -- B2 at level 6 and the warped
    correlation at levels 5..2 -- captured in one CUDA graph (after a warm-up
    on a side stream): the capture counts one launch each and builds
    nothing, and a replay on fresh inputs written in place equals eager
    calls bit for bit."""
    static6 = [t.clone() for t in level6]
    static = [(f1.clone(), f2.clone(), flow.clone(), sc, md) for f1, f2, flow, sc, md in cap_w]

    def run():
        return ([local_corr.local_correlation_cuda(*static6, B2_MD)]
                + [local_corr.warped_correlation_cuda(*a) for a in static])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (local_corr.KERNEL.launches, local_corr.WARPED.launches)
    with torch.cuda.graph(graph):
        outs = run()
    captured = (local_corr.KERNEL.launches - before[0], local_corr.WARPED.launches - before[1])
    g = torch.Generator(device="cuda").manual_seed(22)
    for t in static6 + [t for a in static for t in a[:3]]:
        t.copy_(torch.randn(t.shape, device="cuda", generator=g).to(t.dtype))
    before = (local_corr.KERNEL.launches, local_corr.WARPED.launches)
    graph.replay()
    torch.cuda.synchronize()
    replayed = (local_corr.KERNEL.launches - before[0], local_corr.WARPED.launches - before[1])
    equal = all(torch.equal(o, e) for o, e in zip(outs, run()))
    check(captured == (1, len(static)) and replayed == (0, 0),
          f"graph: B2, warped launches {captured} counted in capture, {replayed} in replay")
    check(equal, "PWC-DC's correlations replayed from a CUDA graph differ from eager calls")
    log(f"B2 and the warped correlation under CUDA graph capture: {1 + len(static)} "
        "correlations captured, replay on new inputs bit-identical to eager calls")
    return {"captured": 1 + len(static), "replay_equals_eager": equal}


def _warped_composition(f1, f2, flow, scale, md, local_corr, dicl):
    """The CUDA composition the warped correlation replaces, on NCHW inputs:
    B1's gather of f2 at grid + flow * scale, the float32 casts, B2 and the
    cast back to f1's dtype."""
    f2h = f2.permute(0, 2, 3, 1).contiguous()
    warped = dicl.bilinear_sample(f2h, _warp_coords(f2h, flow.float(), scale))
    corr = local_corr.local_correlation_cuda(f1.permute(0, 2, 3, 1).float().contiguous(),
                                             warped.float().contiguous(), md)
    return corr.permute(0, 3, 1, 2).to(f1.dtype)


def _warped_bound(f1, flow, md, out_bytes: int, f1_bytes: int, flow_bytes: int):
    """(bytes, flops, operations ms) of one level: f1 and f2 read once at
    `f1_bytes` an element, the flow at `flow_bytes`, the (2md+1)^2 planes
    written at `out_bytes`; C products and sums an output, at the tensor
    cores' bfloat16 rate where the features are bfloat16 (`f1_bytes` 2)
    and at the float32 rate where they are float32; one division an
    output and B1's blend per warped element at the float32 rate."""
    B_, c, h, w = f1.shape
    s2, pix = (2 * md + 1) ** 2, B_ * h * w
    nbytes = 2 * f1.numel() * f1_bytes + flow.numel() * flow_bytes + pix * s2 * out_bytes
    sums, scalar = 2 * c * s2 * pix, s2 * pix + B1_FLOPS_PER_OUTPUT * c * pix
    ops_ms = (sums / (BF16_FLOPS if f1_bytes == 2 else F32_FLOPS) + scalar / F32_FLOPS) * 1e3
    return nbytes, sums + scalar, ops_ms


def _bound_ms(nbytes, ops_ms):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, ops_ms), "bytes" if t_bytes >= ops_ms else "operations"


def phase_warped(path, cap_w, local_corr, correlation, dicl, pwcnet, old_source=None):
    """The warped correlation on the inputs one path gave it (PWC-DC's
    levels 5..2 of a slice-2 pair, `path` "pwc_cli_eval", or of a frozen
    PWC-DC training step, "cli_train_pwc"), in PWC-DC's layout: its
    channels-last features of the network's dtype and up-sampled flow. In bf16 and
    float32, with the main path's flow and one that sends bands of samples
    off the frame: within its plain version's tolerance, two launches
    bit-identical, and bit-identical to the CUDA composition it replaces
    (B1's gather, the casts, B2, the cast back) where both split the
    channels alike (the same cluster size: the same fmaf chains, the ranks'
    partial sums added in the same order). Per level: the
    mapping and its registers, shared memory and resident blocks; device
    time (torch.profiler), ms a call from a CUDA graph, events ms, the
    plain version's time; the bound of this interface and of the earlier
    NHWC float32 one, with shares; PWC-DC's span (`pwcnet._warped_correlate`)
    device time and kernel count (by the trace, and as the kernel nodes of
    a CUDA graph that captures it, which must be the one correlation). With `old_source` (an earlier
    `local_corr.cu`, `--old-b2`): its kernel and the span PWC-DC ran around
    it, timed in turns with the current ones (old, new, new, old), by CUDA
    graph and on the device.

    Tolerances: |kernel - plain| <= 1e-5 max|plain| + 1e-6 (float32 sums in
    another order), plus one bf16 ulp of the output in bf16 (the two sums
    may round to neighbouring bf16 values); the rest bit for bit."""
    old = None if old_source is None else old_warped_correlation(Path(old_source), local_corr)
    calls, max_err = [], 0.0
    for f1, f2, flow, scale, md in cap_w:
        B_, c, h, w = f1.shape
        name = f"{path}_{h}x{w}"
        p = local_corr.warped_plan(B_, c, h, w, md)
        b2_split = local_corr.plan(B_, h, w, c, md).cluster

        def chains(q):   # B2's channel split: each rank's fmaf chain, ranks in order
            return q.cluster == b2_split

        one_block = chains(p)
        for dtype in (torch.bfloat16, torch.float32):
            for what, fl in (("main path", flow), ("off the frame", _off_frame(flow, scale))):
                a, b, fl = f1.to(dtype), f2.to(dtype), fl.to(dtype)
                got = local_corr.warped_correlation_cuda(a, b, fl, scale, md)
                again = local_corr.warped_correlation_cuda(a, b, fl, scale, md)
                ref = correlation.warped_correlation_nchw_plain(a, b, fl, scale, md)
                comp = _warped_composition(a, b, fl, scale, md, local_corr, dicl)
                tag = f"warped correlation {name} {str(dtype)[6:]} {what}"
                check(got.dtype == dtype and got.shape == (B_, (2 * md + 1) ** 2, h, w),
                      f"{tag}: {got.dtype} {tuple(got.shape)}")
                check(torch.equal(got, again), f"{tag}: two launches differ")
                check(torch.equal(got, comp) or not one_block, f"{tag}: differs from gather + "
                      f"cast + B2 + cast by {float((got.float() - comp.float()).abs().max())}")
                err = (got.float() - ref.float()).abs()
                tol = 1e-5 * float(ref.float().abs().max()) + 1e-6
                if dtype == torch.bfloat16:
                    tol = tol + _bf16_ulp(ref)
                max_err = max(max_err, float(err.max()))
                check(bool((err <= tol).all()), f"{tag}: max |kernel - plain| = "
                      f"{float(err.max())} beyond tolerance")
        res = local_corr.WARPED.resources(p, f1.dtype)

        def run():
            return local_corr.warped_correlation_cuda(f1, f2, flow, scale, md)

        def span():
            return pwcnet._warped_correlate(f1, f2, flow, scale, md)

        ms = cuda_ms(run, reps=50)
        plain_ms = cuda_ms(lambda: correlation.warped_correlation_nchw_plain(f1, f2, flow, scale,
                                                                             md),
                           reps=5, warmup=1)
        nbytes, flops, ops_ms = _warped_bound(f1, flow, md, f1.element_size(),
                                              f1.element_size(), flow.element_size())
        # the earlier NHWC interface: float32 f1, flow and output, float32 sums
        bytes_nhwc, _, ops_ms_nhwc = _warped_bound(f1, flow, md, 4, 4, 4)
        bytes_nhwc -= f2.numel() * (4 - f2.element_size())   # f2 was read in its own dtype
        bound, bound_by = _bound_ms(nbytes, ops_ms)
        bound_nhwc, bound_by_nhwc = _bound_ms(bytes_nhwc, ops_ms_nhwc)
        if old:   # the earlier kernel alone, on the inputs its span made for it
            a1, a2, af = (f1.permute(0, 2, 3, 1).float().contiguous(),
                          f2.permute(0, 2, 3, 1).contiguous(), flow.float().contiguous())
        turns = {}
        for who in ("old", "new", "new", "old") if old else ("new",):
            if who == "new":
                kernel, sp, kernel_name = run, span, "warped_corr_kernel"
            else:
                kernel = lambda: old[0](a1, a2, af, scale, md)  # noqa: E731
                sp = lambda: old[1](f1, f2, flow, scale, md)  # noqa: E731
                kernel_name = "local_corr_kernel"
            row = turns.setdefault(who, dict(device_ms=[], graph_ms=[], span_device_ms=[],
                                             span_kernels=[], span_graph_ms=[]))
            row["device_ms"].append(device_ms(kernel, kernel_name))
            row["graph_ms"].append(graph_ms(kernel))
            span_ms, span_n = _profile_sums(_full_profile(sp))
            row["span_device_ms"].append(span_ms)
            row["span_kernels"].append(span_n)
            row["span_graph_ms"].append(graph_ms(sp))
        # the span's kernels, counted as a CUDA graph's kernel nodes (the earlier span's too)
        span_launches = graph_kernels(span)
        old_launches = graph_kernels(lambda: old[1](f1, f2, flow, scale, md)) if old else None
        check(span_launches == 1, f"warped correlation {name}: PWC-DC's span launches "
              f"{span_launches} kernels, not the one correlation")
        if old:
            check(torch.equal(old[1](f1, f2, flow, scale, md), span()) or not one_block,
                  f"warped correlation {name}: differs from the earlier span")
        dev = turns["new"]["device_ms"][0]
        calls.append(dict(
            name=name, f1=list(f1.shape), dtype=str(f1.dtype)[6:], flow_dtype=str(flow.dtype)[6:],
            md=md, scale=scale, ms=ms, device_ms=dev, graph_ms=turns["new"]["graph_ms"][0],
            plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=bound_by,
            bound_share=None if dev is None else bound / dev, bytes=nbytes, flops=flops,
            ops_ms=ops_ms, bytes_nhwc_basis=bytes_nhwc, ops_ms_nhwc_basis=ops_ms_nhwc,
            bound_ms_nhwc_basis=bound_nhwc,
            bound_by_nhwc_basis=bound_by_nhwc,
            bound_share_nhwc_basis=None if dev is None else bound_nhwc / dev,
            same_split_as_b2=one_block,
            span_now_device_ms=turns["new"]["span_device_ms"][0],
            span_now_kernels=turns["new"]["span_kernels"][0],
            span_now_graph_kernels=span_launches, span_old_graph_kernels=old_launches,
            span_now_graph_ms=turns["new"]["span_graph_ms"][0], turns=turns if old else None,
            mapping=dict(px=p.px, cluster=p.cluster, grid=list(p.grid),
                         block=list(p.block), warps=p.warps, **res)))
        r = calls[-1]
        share = "not measured" if dev is None else f"{100 * bound / dev:.1f}%"
        log(f"warped correlation {name}: f1 {tuple(f1.shape)} {r['dtype']}, flow "
            f"{r['flow_dtype']}, scale {scale}: device {_fmt_ms(dev)}, graph "
            f"{r['graph_ms']:.4f} ms, events "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by}, "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP), share {share} (NHWC float32 basis "
            f"{bound_nhwc:.5f} ms, {bound_by_nhwc}); span now {_fmt_ms(r['span_now_device_ms'])} "
            f"in {r['span_now_kernels']} kernels by the trace, {span_launches} in its CUDA graph "
            f"(graph {r['span_now_graph_ms']:.4f} ms); mapping "
            f"px {p.px} cluster {p.cluster}, {p.warps} warps, {res['registers']} "
            f"registers, {res['smem_bytes']} B shared, {res['blocks_per_sm']} blocks/SM; "
            f"B2's channel split, so bit-identical to gather + casts + B2: {one_block}")
        if old:
            log(f"  in turns (old, new, new, old): {json.dumps(turns)}")
    total = _pair_sums(calls)
    total["graph_ms"] = sum(c["graph_ms"] for c in calls)
    b_nhwc, total["bound_by_nhwc_basis"] = _bound_ms(sum(c["bytes_nhwc_basis"] for c in calls),
                                                     sum(c["ops_ms_nhwc_basis"] for c in calls))
    total["bound_ms_nhwc_basis"] = b_nhwc
    for key in ("span_now_device_ms", "span_now_kernels", "span_now_graph_kernels",
                "span_old_graph_kernels"):
        total[key] = _sum_or_none(c[key] for c in calls)
    total["span_now_graph_ms"] = sum(c["span_now_graph_ms"] for c in calls)
    dev = total["device_ms"]
    total["bound_share"] = None if dev is None else total["bound_ms"] / dev
    total["bound_share_nhwc_basis"] = None if dev is None else b_nhwc / dev
    if old:
        total["turns"] = {
            who: {k: [_sum_or_none(c["turns"][who][k][i] for c in calls) for i in range(2)]
                  for k in calls[0]["turns"][who]} for who in ("old", "new")}
    log(f"warped correlation per {'pair' if path == 'pwc_cli_eval' else 'step'} ({path}, levels "
        f"5..2): device {_fmt_ms(dev)}, graph {total['graph_ms']:.4f} ms, events "
        f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms ({total['bound_by']}; "
        f"NHWC float32 basis {b_nhwc:.4f} ms); span now {_fmt_ms(total['span_now_device_ms'])} in "
        f"{total['span_now_kernels']} kernels by the trace, {total['span_now_graph_kernels']} "
        f"in its CUDA graph (the earlier span's: {total['span_old_graph_kernels']}; graph "
        f"{total['span_now_graph_ms']:.4f} ms)"
        + (f"; in turns {json.dumps(total['turns'])}" if old else ""))
    return dict(total, calls=calls), max_err


def _fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def _sum_or_none(vals):
    vals = list(vals)
    return None if None in vals else sum(vals)


def _pair_sums(calls):
    # each call's operations at their own rates (`ops_ms`), else its flops at
    # the float32 rate
    t_bytes = sum(c["bytes"] for c in calls) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(c.get("ops_ms", c["flops"] / F32_FLOPS * 1e3) for c in calls)
    out = {k: sum(c[k] for c in calls) for k in ("ms", "plain_ms")}
    out["device_ms"] = (None if any(c["device_ms"] is None for c in calls)
                        else sum(c["device_ms"] for c in calls))
    out.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    for key in ("library_ms", "library_device_ms"):
        if all(c.get(key) is not None for c in calls):
            out[key] = sum(c[key] for c in calls)
        elif key == "library_ms":
            out[key] = None
    return out


def _host_us(fn, reps: int = 2000) -> float:
    """Host microseconds per call of `fn` (no synchronize: what the caller's
    thread spends before the next call can start)."""
    for _ in range(50):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def gather_host_breakdown(img, coords, sweep_warp) -> dict:
    """The gather's host time per call, piece by piece: the earlier ctypes
    wrapper's pieces (the build lock, the device context, the Stream object,
    its attribute checks, torch.empty and the ctypes call that launches) and
    its whole path rebuilt here; a slim ctypes path (raw stream, new_empty, the
    call) rebuilt here; the operator the port launches through; and
    F.grid_sample's host time on the same query count."""
    import ctypes

    kernel = sweep_warp.KERNEL
    fn = kernel.build().dsfm_bilinear_sample
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev, index = img.device, img.get_device()
    B_, H_, W_, C_ = img.shape
    code = {torch.float32: 0, torch.bfloat16: 1}[img.dtype]
    shape = coords.shape[:-1] + (C_,)
    Q = math.prod(shape) // (B_ * C_)
    out = torch.empty(shape, dtype=img.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (img.data_ptr(), coords.data_ptr(), out.data_ptr(), B_, H_, W_, C_, Q, code, 1)

    def ctypes_checks():
        ok = (img.is_cuda and coords.is_cuda and img.device == coords.device
              and img.dtype in (torch.float32, torch.bfloat16) and coords.dtype == torch.float32
              and img.dim() == 4 and coords.dim() >= 2 and coords.shape[-1] == 2
              and coords.shape[0] == img.shape[0] and img.is_contiguous()
              and coords.is_contiguous() and coords.data_ptr() % 8 == 0)
        b, h, w, c = img.shape
        return ok and min(b, h, w, c) >= 1 and img.data_ptr() % 16 == 0

    def device_context():
        with torch.cuda.device(dev):
            pass

    def ctypes_path():
        """The earlier ctypes wrapper's host path (ops/cuda/sweep_warp.py
        before the operators)."""
        if not ctypes_checks():
            raise AssertionError("checks")
        o = torch.empty(shape, dtype=img.dtype, device=img.device)
        lib_ = kernel.build()
        with torch.cuda.device(img.device):
            st = torch.cuda.current_stream(img.device).cuda_stream
            lib_.dsfm_bilinear_sample(img.data_ptr(), coords.data_ptr(), o.data_ptr(), B_, H_,
                                      W_, C_, Q, code, 1, st)
        return o

    def slim_ctypes():
        o = img.new_empty(shape)
        fn(img.data_ptr(), coords.data_ptr(), o.data_ptr(), B_, H_, W_, C_, Q, code, 1,
           torch._C._cuda_getCurrentRawStream(index))
        return o

    grid = (coords / torch.tensor([W_ - 1.0, H_ - 1.0], device=dev) * 2 - 1).to(img.dtype)
    img_nchw = img.permute(0, 3, 1, 2)
    pieces = {
        "ctypes wrapper: build() under its lock": _host_us(kernel.build),
        "ctypes wrapper: torch.cuda.device enter + exit": _host_us(device_context),
        "ctypes wrapper: current_stream().cuda_stream": _host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "ctypes wrapper: attribute checks": _host_us(ctypes_checks),
        "ctypes wrapper: torch.empty": _host_us(
            lambda: torch.empty(shape, dtype=img.dtype, device=dev)),
        "ctypes call + launch": _host_us(lambda: fn(*args, stream)),
        "ctypes wrapper: whole path": _host_us(ctypes_path),
        "slim ctypes: raw stream + current device": _host_us(
            lambda: (torch._C._cuda_getCurrentRawStream(index), torch._C._cuda_getDevice())),
        "slim ctypes: new_empty": _host_us(lambda: img.new_empty(shape)),
        "slim ctypes: whole path": _host_us(slim_ctypes),
        "operator: whole wrapper": _host_us(lambda: sweep_warp.bilinear_sample_cuda(img, coords)),
        "F.grid_sample": _host_us(lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                                        padding_mode="zeros",
                                                        align_corners=True)),
    }
    got = sweep_warp.bilinear_sample_cuda(img, coords)
    check(torch.equal(ctypes_path(), got) and torch.equal(slim_ctypes(), got),
          "the rebuilt ctypes paths and the operator give different gathers")
    log("B1 gather host us per call (img " + f"{tuple(img.shape)}): "
        + "; ".join(f"{k} {v:.2f}" for k, v in pieces.items()))
    return pieces


def gather_graph_check(captured, sweep_warp) -> dict:
    """The flow warps' four gathers captured in one CUDA graph (after a
    warm-up on a side stream, as torch.cuda.graph asks): the capture adds
    one launch per gather and builds nothing, and a replay on fresh inputs
    written in place equals an eager call bit for bit."""
    static = [(img.clone(), coords.clone()) for img, coords in captured]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for img, coords in static:
            sweep_warp.bilinear_sample_cuda(img, coords)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = sweep_warp.KERNEL.launches
    with torch.cuda.graph(graph):
        outs = [sweep_warp.bilinear_sample_cuda(img, coords) for img, coords in static]
    captured_launches = sweep_warp.KERNEL.launches - before
    g = torch.Generator(device="cuda").manual_seed(21)
    for img, coords in static:
        h, w = img.shape[1:3]
        img.copy_(torch.randn(img.shape, device="cuda", generator=g).to(img.dtype))
        coords.copy_(torch.rand(coords.shape, device="cuda", generator=g) * 1.2 - 0.1)
        coords.mul_(torch.tensor([w - 1.0, h - 1.0], device="cuda"))
    before = sweep_warp.KERNEL.launches
    graph.replay()
    torch.cuda.synchronize()
    replay_launches = sweep_warp.KERNEL.launches - before
    equal = all(torch.equal(o, sweep_warp.bilinear_sample_cuda(img, coords))
                for o, (img, coords) in zip(outs, static))
    check(captured_launches == len(static) and replay_launches == 0,
          f"graph: {captured_launches} launches counted in capture, {replay_launches} in replay")
    check(equal, "the gather's CUDA-graph replay differs from an eager call")
    log(f"B1 gather under CUDA graph capture: {len(static)} gathers captured, replay on new "
        "inputs bit-identical to eager calls")
    return {"gathers": len(static), "replay_equals_eager": equal}


def phase_kernel(captured, sweep_warp, camera):
    """B1's generic gather vs its plain version at PWC-DC's flow warps'
    inputs (DICL's warps are fused into its displacement volume); times and
    bounds; the host time per call piece by piece; the four warps replayed
    from a CUDA graph.

    Tolerance: exact in bf16 and float32 -- the kernel rounds op by op with
    __fmul_rn/__fadd_rn in the plain version's order (the card's own bound
    would be 1e-6 in float32 and one bf16 ulp)."""
    calls, max_err = [], 0.0
    for img, coords in captured:
        _, h, w, _ = img.shape
        name = f"pwc_warp_{h}x{w}"
        edged, zero = _with_edges(coords, h, w)
        invalid = ((coords[..., 0] < 0) | (coords[..., 0] > w - 1)
                   | (coords[..., 1] < 0) | (coords[..., 1] > h - 1)).float().mean()
        for dtype in (torch.bfloat16, torch.float32):
            x = img.to(dtype)
            for c in (coords, edged):
                got = sweep_warp.bilinear_sample_cuda(x, c)
                ref = camera.bilinear_sample_plain(x, c)
                err = float((got.float() - ref.float()).abs().max())
                max_err = max(max_err, err)
                check(err == 0.0, f"B1 {name} {dtype}: max |kernel - plain| = {err}")
            check((got.reshape(zero.shape + (-1,))[zero] == 0).all(),
                  f"B1 {name} {dtype}: out-of-range samples are not zero")
        out = sweep_warp.bilinear_sample_cuda(img, coords)
        grid = coords.reshape(B, -1, coords.shape[-2], 2)
        grid = (grid / torch.tensor([w - 1.0, h - 1.0], device=grid.device) * 2 - 1)
        grid = grid.to(img.dtype)
        img_nchw = img.permute(0, 3, 1, 2)
        ms = cuda_ms(lambda: sweep_warp.bilinear_sample_cuda(img, coords), reps=20)
        dev_ms = device_ms(lambda: sweep_warp.bilinear_sample_cuda(img, coords),
                           "bilinear_sample_kernel")
        plain_ms = cuda_ms(lambda: camera.bilinear_sample_plain(img, coords), reps=3, warmup=1)
        def library():
            F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)

        library_ms = cuda_ms(library, reps=20)
        library_dev_ms = _profile_sums(_full_profile(library))[0]
        nbytes = (img.numel() * img.element_size() + coords.numel() * coords.element_size()
                  + out.numel() * out.element_size())
        flops = B1_FLOPS_PER_OUTPUT * out.numel()
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        calls.append(dict(name=name, img=list(img.shape), coords=list(coords.shape),
                          dtype=str(img.dtype).replace("torch.", ""),
                          out_of_range=float(invalid), ms=ms, device_ms=dev_ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          library_device_ms=library_dev_ms, bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else "operations",
                          bytes=nbytes, flops=flops))
        log(f"B1 {name}: img {tuple(img.shape)} coords {tuple(coords.shape)} "
            f"{calls[-1]['dtype']}: kernel {ms:.4f} ms (device "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), plain {plain_ms:.4f} ms, "
            f"grid_sample {library_ms:.4f} ms (device "
            f"{'not measured' if library_dev_ms is None else f'{library_dev_ms:.4f} ms'}), "
            f"bound {calls[-1]['bound_ms']:.4f} ms "
            f"({calls[-1]['bound_by']}, {nbytes / 1e6:.1f} MB); "
            f"{100 * float(invalid):.1f}% of queries out of range")
    img, coords = captured[0]
    extras = {"host_breakdown_us": gather_host_breakdown(img, coords, sweep_warp),
              "graph": gather_graph_check(captured, sweep_warp)}
    pair = _pair_sums(calls)
    log(f"B1 PWC-DC gather per pair: events {pair['ms']:.4f} ms, F.grid_sample "
        f"{pair['library_ms']:.4f} ms by events: the kernel "
        f"{'is no slower' if pair['ms'] <= pair['library_ms'] else 'is slower'}")
    return calls, max_err, extras


def _sweep_variants(ref, tgt, depths, M, Kt):
    """PSNet's sweep inputs and the edge cases built from them: the target
    map's frame border at 100 (a read across the border would show), K t
    moved back so the nearer half of the planes lies behind the camera, and
    K t moved sideways by 2 W depths[D // 4], so every sample on a plane
    nearer than about twice that depth leaves the frame (most planes)."""
    W = ref.shape[2]
    D = depths.shape[0]
    behind, outward = Kt.clone(), Kt.clone()
    behind[:, 2] = -depths[D // 2]
    outward[:, 0] += 2 * W * depths[D // 4]
    return {"main path": (ref, tgt, depths, M, Kt),
            "edged": (ref, _edged_features(tgt), depths, M, Kt),
            "behind the camera": (ref, tgt, depths, M, behind),
            "out of frame": (ref, tgt, depths, M, outward)}


def phase_sweep(captured, sweep_warp, camera):
    """B1's sweep kernel vs its plain version on PSNet's inputs from both
    main paths and on their edge cases (`_sweep_variants`), bf16 and
    float32; times, bound, and the composition it replaced.

    Tolerance: exact -- the kernel computes the coordinates and the blend
    op by op in the plain version's order with __fmul_rn/__fadd_rn/
    __fdiv_rn. Where the sample is invalid (out of the frame, or behind the
    camera) the warped half must be exactly zero; the ref half is the ref
    features on every plane; the (B, 2C, D, H, W) view has channels-last-3d
    strides."""
    max_err, zero_share = 0.0, {}
    for idx, inputs in enumerate(captured):
        for what, (ref, tgt, depths, M, Kt) in _sweep_variants(*inputs).items():
            B, H, W, C = ref.shape
            D = depths.shape[0]
            x, y = camera.sweep_pixel_coords(depths, M, Kt, H, W)
            invalid = (x < 0) | (x > W - 1) | (y < 0) | (y > H - 1)
            zero_share[what] = float(invalid.float().mean())
            for dtype in (torch.bfloat16, torch.float32):
                r, t = ref.to(dtype), tgt.to(dtype)
                got = sweep_warp.plane_sweep_volume_cuda(r, t, depths, M, Kt)
                plain = camera.plane_sweep_volume_plain(r, t, depths, M, Kt)
                err = float((got.float() - plain.float()).abs().max())
                max_err = max(max_err, err)
                name = f"sweep input {idx} {what} {str(dtype)[6:]}"
                check(err == 0.0, f"{name}: max |kernel - plain| = {err}")
                check(got.shape == (B, D, H, W, 2 * C), f"{name}: shape {tuple(got.shape)}")
                check(torch.equal(got[..., :C], r[:, None].expand(B, D, H, W, C)),
                      f"{name}: the ref half is not the ref features")
                check((got[..., C:][invalid] == 0).all(), f"{name}: invalid samples not zero")
                check(got.permute(0, 4, 1, 2, 3).is_contiguous(
                    memory_format=torch.channels_last_3d), f"{name}: not channels-last-3d")
                del got, plain
        log(f"sweep input {idx} {tuple(inputs[0].shape)} x {inputs[2].shape[0]} planes: "
            f"kernel == plain in bf16 and float32 on all variants; invalid share "
            + ", ".join(f"{k} {100 * v:.2f}%" for k, v in zero_share.items()))

    ref, tgt, depths, M, Kt = captured[0]
    B, H, W, C = ref.shape
    D = depths.shape[0]
    out = sweep_warp.plane_sweep_volume_cuda(ref, tgt, depths, M, Kt)

    def run():
        sweep_warp.plane_sweep_volume_cuda(ref, tgt, depths, M, Kt)

    def old_composition():
        """The earlier path: coordinates in device memory, the generic gather, the
        NCDHW concat, then the channels-last-3d copy cuDNN made of it."""
        coords = torch.stack(camera.sweep_pixel_coords(depths, M, Kt, H, W), dim=-1)
        warped = sweep_warp.bilinear_sample_cuda(tgt, coords)
        cost = torch.cat([ref.permute(0, 3, 1, 2)[:, :, None].expand(B, C, D, H, W),
                          warped.permute(0, 4, 1, 2, 3)], dim=1)
        return cost.contiguous(memory_format=torch.channels_last_3d)

    check(torch.equal(old_composition(), out.permute(0, 4, 1, 2, 3)),
          "the old composition and the sweep kernel build different volumes")
    ms = cuda_ms(run, reps=20)
    dev_ms = device_ms(run, "plane_sweep_volume_kernel")
    plain_ms = cuda_ms(lambda: camera.plane_sweep_volume_plain(ref, tgt, depths, M, Kt),
                       reps=3, warmup=1)
    old_ms = cuda_ms(old_composition, reps=10)
    old_profile = _full_profile(old_composition, reps=10)
    old_dev_ms, old_kernels = _profile_sums(old_profile)
    nbytes = sum(t.numel() * t.element_size() for t in (ref, tgt, depths, M, Kt, out))
    flops = (B1_FLOPS_PER_OUTPUT * out.numel() // 2
             + SWEEP_FLOPS_PER_SAMPLE * out.numel() // (2 * C))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    call = dict(name="psnet_cost_volume", ref=list(ref.shape), planes=D,
                out=list(out.shape), dtype=str(ref.dtype).replace("torch.", ""), ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_share=None if dev_ms is None else bound / dev_ms, bytes=nbytes,
                flops=flops, old_composition_ms=old_ms, old_composition_device_ms=old_dev_ms,
                old_composition_kernels=old_kernels,
                old_composition_top={n: v[0] for n, v in sorted(
                    (old_profile or {}).items(), key=lambda kv: -kv[1][0])[:6]})
    share = "not measured" if dev_ms is None else f"{100 * bound / dev_ms:.1f}%"
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"   # noqa: E731
    log(f"sweep kernel: ref/tgt {tuple(ref.shape)} {call['dtype']}, {D} planes -> "
        f"{tuple(out.shape)}: device {fmt(dev_ms)}, events {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({call['bound_by']}, {nbytes / 1e6:.1f} MB), "
        f"share of bound {share}; old composition device {fmt(old_dev_ms)} in "
        f"{old_kernels} kernels, events {old_ms:.4f} ms; its largest: "
        + "; ".join(f"{ms:.4f} ms {n[:70]}" for n, ms in call["old_composition_top"].items()))
    return call, max_err


# slice 5: the recipe's frozen-flow depth-training step at its crop, b = 4
TRAIN_B, TRAIN_HW, TRAIN_STEPS = 4, (256, 768), 5
# gather, sweep, sweep backward, sweep pose gradient (the RANSAC pose is
# stop-gradient; PoseNet's is not), displacement volume (DICL's levels)
TRAIN_PER_STEP = (0, SWEEP_PER_PAIR, 1, 0, DISP_PER_PAIR)
POSENET_PER_STEP = (0, SWEEP_PER_PAIR, 1, 1, DISP_PER_PAIR)
# the sweep backward: per (b, d, y, x) the coordinates (8) and the 4 tap
# weights; per channel the ref sum and the 4 weighted taps (product, sum)
BWD_FLOPS_PER_SAMPLE, BWD_FLOPS_PER_CHANNEL = 12, 9
BWD_REPLACES = "deep_sfm_revisited_tpu/models/psnet.py:253"


def _grad_report(got: dict, want: dict):
    """Per tensor max |got - want| / max |want| (0 where both are all zero),
    and 1 - cosine of the concatenated gradients."""
    errs = {}
    for k, w in want.items():
        scale = float(w.abs().max())
        diff = float((got[k] - w).abs().max())
        errs[k] = diff / scale if scale > 0 else diff
    g = torch.cat([got[k].double().flatten() for k in want])
    w = torch.cat([want[k].double().flatten() for k in want])
    return errs, float(1 - (g @ w) / (g.norm() * w.norm()))


def phase_small_train_reference(dev, posenet: bool = False) -> None:
    """One train step of the port at 128x128 (nlabel 8, the SMALL pose
    overrides), float32, TF32 off, on the card, against the same step on the
    CPU (plain versions) with the same weights, batch, noise and RANSAC
    draws. On the RANSAC route the CPU runs at the card's RANSAC pose
    (`pred_pose_online=False` with that pose): with random weights the vote
    is degenerate across devices (phase 3). With `posenet` the route is
    POSENET (PoseNet's pose, trained through the sweep's pose gradient),
    which both devices run online, and PoseNet's gradients join PSNet's.

    Tolerances: the loss to 1e-4 relative. The gradients: the two devices
    sum in other orders (the sweep backward's atomics, cuDNN's backward),
    and at random weights a float32 ReLU whose input lies within rounding of
    zero switches between them; one such unit moves a weight's gradient by
    ~1/sqrt(positions) of its largest element (and on the POSENET route a
    sample of the sweep that crosses a tap moves the pose's gradient). The
    phase measures that on the CPU alone, as the largest move over the same
    step at three inputs scaled by 1 + 1e-6, 1 - 1e-6 and 1 + 3e-6, and
    holds the card, tensor by tensor, to twice that move (at least 1e-3 of
    the tensor's largest element), and to 1 - cosine <= 1e-4 over all the
    compared gradients.

    The witness for that cause: the inputs of every ReLU of the trained
    networks are recorded on both devices; the units whose sign differs
    must each have an input within 1e-4 of its tensor's largest (rounding,
    not a fault), and the CPU step rerun with the card's ReLU masks (each
    ReLU's output x * mask) must give every gradient within 1e-3 of its
    largest element of the card's."""
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
    from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp
    from deep_sfm_revisited_tpu_torch.train.trainer import Trainer, add_image_noise

    route = {"pose.estimator": "POSENET"} if posenet else {}
    cfg = SfMConfig.kitti().override(**SMALL, **route, **{"train.mixed_prec": False})
    what = "small train reference" + (" (POSENET)" if posenet else "")
    trained = ("depth_estimator", "posenet") if posenet else ("depth_estimator",)
    h = w = 128
    g = torch.Generator().manual_seed(8)
    ref = torch.rand((1, h, w, 3), generator=g) * 2 - 1
    a = 0.03
    batch = {"ref": ref, "target": torch.roll(ref, (1, 3), dims=(1, 2))
             + 0.05 * torch.randn((1, h, w, 3), generator=g),
             "intrinsics": torch.tensor([[[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]]]),
             "pose_gt": torch.tensor([[[math.cos(a), 0, math.sin(a), 0.2], [0, 1, 0, 0.0],
                                       [-math.sin(a), 0, math.cos(a), 0.7]]]),
             "depth_gt": torch.where(torch.rand((1, h, w), generator=g) < 0.3,
                                     1.5 + 6 * torch.rand((1, h, w), generator=g), 0.0)}
    batch = add_image_noise(batch, torch.Generator().manual_seed(9))
    n_cand = 4 * cfg.pose.num_correspondences
    draws = {"jitter": torch.rand((1, n_cand, 2), generator=g) - 0.5,
             "gumbel_u": torch.rand((1, n_cand), generator=g) * (1 - 1e-12) + 1e-12,
             "sample_idx": torch.randint(0, cfg.pose.num_correspondences,
                                         (1, cfg.pose.num_hypotheses, 5), generator=g)}

    def grads(model):
        return {f"{m}.{k}": p.grad for m in trained
                for k, p in getattr(model, m).named_parameters()}

    def relu_hooks(model, fn):
        # fn(name, input) on every nn.ReLU of the trained networks, in call
        # order; a value it returns replaces the ReLU's output
        return [mod.register_forward_hook(lambda mod, a, o, name=f"{m}.{n}": fn(name, a[0]))
                for m in trained for n, mod in getattr(model, m).named_modules()
                if isinstance(mod, torch.nn.ReLU)]

    card = Trainer(SFMNet(cfg, device=dev, seed=1), cfg, steps_per_epoch=1)
    poses, card_relu = [], []
    card.model.depth_estimator.register_forward_pre_hook(
        lambda m, args: poses.append(args[2][:, 0].detach().clone()))
    handles = relu_hooks(card.model, lambda name, x: card_relu.append((name, x.detach().cpu())))
    counters = (sweep_warp.VOLUME_BACKWARD, sweep_warp.VOLUME_POSE_GRAD)
    before = _launches(*counters)
    m_card = card.train_step({k: v.to(dev) for k, v in batch.items()}, noise=False,
                             draws={k: v.to(dev) for k, v in draws.items()})
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    n = tuple(x - y for x, y in zip(_launches(*counters), before))
    check(n == (1, int(posenet)), f"{what}: the sweep backward and pose-gradient kernels "
          f"launched {n} times, expected {(1, int(posenet))}")
    check(posenet == ("pose_loss" in m_card), f"{what}: metrics {sorted(m_card)}")
    g_card = {k: v.cpu() for k, v in grads(card.model).items()}

    cpu_cfg = cfg if posenet else cfg.override(pred_pose_online=False)

    def cpu_step(scale, record=None, masks=None):
        t = Trainer(SFMNet(cpu_cfg, device="cpu", seed=1), cpu_cfg, steps_per_epoch=1)
        b = dict(batch, ref=batch["ref"] * scale, pred_pose=poses[0].cpu())
        calls = iter(range(len(masks or ())))

        def hook(name, x):
            if record is not None:
                record.append((name, x.detach().clone()))
            return None if masks is None else x * masks[next(calls)]

        handles = relu_hooks(t.model, hook)
        try:
            m = t.train_step(b, noise=False)
        finally:
            for h in handles:
                h.remove()
        return m, grads(t.model)

    cpu_relu = []
    m_cpu, g_cpu = cpu_step(1.0, record=cpu_relu)
    self_errs, self_cos = {}, 0.0
    for scale in (1 + 1e-6, 1 - 1e-6, 1 + 3e-6):
        e, c = _grad_report(cpu_step(scale)[1], g_cpu)
        self_errs = {k: max(v, self_errs.get(k, 0.0)) for k, v in e.items()}
        self_cos = max(self_cos, c)
    loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    errs, cos_err = _grad_report(g_card, g_cpu)
    worst = max(errs, key=errs.get)
    log(f"{what}: loss card {float(m_card['loss']):.7f} vs cpu "
        f"{float(m_cpu['loss']):.7f} (relative {loss_err:.2e}); {' and '.join(trained)} "
        f"gradients: {sum(e <= 1e-3 for e in errs.values())}/{len(errs)} tensors within 1e-3 "
        f"of their max, worst {errs[worst]:.2e} ({worst}), 1 - cosine {cos_err:.2e}; the CPU "
        f"against itself at three perturbed inputs: worst {max(self_errs.values()):.2e}, "
        f"{sum(e > 1e-3 for e in self_errs.values())} tensors beyond 1e-3, 1 - cosine "
        f"{self_cos:.2e}")

    check([n for n, _ in card_relu] == [n for n, _ in cpu_relu],
          f"{what}: the ReLUs ran in another order on the card than on the CPU")
    flips = []          # (ReLU, units of other sign, largest such |input| / max |input|)
    for (name, xc), (_, xp) in zip(card_relu, cpu_relu):
        other = (xc > 0) != (xp > 0)
        if other.any():
            near = torch.maximum(xc.abs(), xp.abs())[other].max()
            flips.append((name, int(other.sum()), float(near / xp.abs().max())))
    _, g_forced = cpu_step(1.0, masks=[(x > 0).to(x.dtype) for _, x in card_relu])
    f_errs, f_cos = _grad_report(g_card, g_forced)
    f_worst = max(f_errs, key=f_errs.get)
    by_units = sorted(flips, key=lambda f: -f[1])[:4]
    log(f"{what}: ReLU units of other sign on the card than on the CPU: "
        f"{sum(f[1] for f in flips)} in {len(flips)} of {len(card_relu)} ReLU calls, their "
        f"largest input {max((f[2] for f in flips), default=0.0):.2e} of its tensor's max "
        f"(most in {', '.join(f'{n} {u}' for n, u, _ in by_units) or 'none'}); the CPU step "
        f"with the card's ReLU masks: worst {f_errs[f_worst]:.2e} ({f_worst}), "
        f"{worst} {f_errs[worst]:.2e}, 1 - cosine {f_cos:.2e}")
    check(all(f[2] <= 1e-4 for f in flips), f"{what}: a ReLU unit of other sign on the card "
          f"has an input beyond 1e-4 of its tensor's max: {max(flips, key=lambda f: f[2])}")
    check(f_errs[f_worst] <= 1e-3, f"{what}: with the card's ReLU masks the CPU gradient "
          f"{f_worst} still differs by {f_errs[f_worst]} of its max, beyond 1e-3")
    check(math.isfinite(float(m_card["loss"])), f"{what}: non-finite loss")
    check(loss_err <= 1e-4, f"{what}: loss differs by {loss_err}")
    bound = max(1e-3, 2 * max(self_errs.values()))
    check(errs[worst] <= bound, f"{what}: gradient {worst} differs by "
          f"{errs[worst]} of its max, beyond {bound}")
    check(cos_err <= 1e-4, f"{what}: 1 - cosine of the gradients {cos_err}")


class TrainStageTimer(StageTimer):
    """StageTimer's flow, pose and depth-forward events plus the step's
    start and end and the Adam update's; the loss and backward are the time
    between the depth network's exit and Adam's start. On the POSENET route
    PoseNet's forward is timed on its own as well (within the pose stage)."""

    def __init__(self, trainer):
        super().__init__(trainer.model)
        trainer.optimizer.register_step_pre_hook(lambda o, a, k: self._mark("adam_start"))
        trainer.optimizer.register_step_post_hook(lambda o, a, k: self._mark("adam_end"))
        posenet = getattr(trainer.model, "posenet", None)
        if posenet is not None:
            posenet.register_forward_pre_hook(lambda m, a: self._mark("posenet_start"))
            posenet.register_forward_hook(lambda m, a, o: self._mark("posenet_end"))

    def stages_ms(self):
        e = self.events
        out = super().stages_ms()
        out.update(prep=e["step_start"].elapsed_time(e["flow_start"]),
                   backward=e["depth_end"].elapsed_time(e["adam_start"]),
                   adam=e["adam_start"].elapsed_time(e["adam_end"]),
                   step=e["step_start"].elapsed_time(e["step_end"]))
        if "posenet_start" in e:
            out["posenet"] = e["posenet_start"].elapsed_time(e["posenet_end"])
        return out


def phase_cli_train(dev, sweep_warp, posenet: bool = False):
    """Slice 5 through `cli.main` in training mode on a rendered golden KITTI
    raw tree (370x1224, cropped to the recipe's 256x768, b = 4, nlabel 128,
    bf16, the slices' pose overrides): one warm-up step, which records the
    sweep backward's and the displacement volume's inputs, then TRAIN_STEPS
    timed steps with the launch counts reset after the warm-up, then the
    epoch's validation and checkpoint. Each step must launch the
    displacement volume 5 times, the sweep and the sweep backward once, the
    gather and the sweep pose gradient no time, give a finite loss, leave
    DICL's parameters bit-identical, move every DICL BN running mean and
    every PSNet parameter that got a gradient. With `posenet`, the same with
    `pose.estimator=POSENET` (slice 7): the pose gradient launches once a
    step (the warm-up records its inputs too), the loss has its `pose_loss`
    term, and PoseNet's parameters move. Returns (launches over the run
    after the warm-up (gather, sweep, sweep backward, sweep pose gradient,
    displacement volume), the sweep backward's inputs, the pose gradient's
    inputs, the displacement volume's inputs)."""
    from deep_sfm_revisited_tpu_torch import cli
    from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_raw_tree
    from deep_sfm_revisited_tpu_torch.train.trainer import Trainer

    what = "cli train (POSENET)" if posenet else "cli train"
    per_step = POSENET_PER_STEP if posenet else TRAIN_PER_STEP
    counters = (sweep_warp.KERNEL, sweep_warp.VOLUME, sweep_warp.VOLUME_BACKWARD,
                sweep_warp.VOLUME_POSE_GRAD, sweep_warp.DISPLACEMENT)
    real_step = Trainer.train_step
    backward = sweep_warp.plane_sweep_volume_backward_cuda
    pose_grad = sweep_warp.plane_sweep_volume_pose_grad_cuda
    rows, captured, cap_pose, cap_disp, timer = [], [], [], [], []

    def record_backward(*args):
        captured.append(tuple(a.clone() for a in args))
        return backward(*args)

    def record_pose_grad(*args):
        cap_pose.append(tuple(a.clone() for a in args))
        return pose_grad(*args)

    def timed_step(trainer, *args, **kw):
        warm = not timer
        if warm:
            timer.append(TrainStageTimer(trainer))
            sweep_warp.plane_sweep_volume_backward_cuda = record_backward
            sweep_warp.plane_sweep_volume_pose_grad_cuda = record_pose_grad
        model = trainer.model
        dicl = {k: v.clone() for k, v in model.flow_estimator.state_dict().items()}
        trained = [("PSNet", model.depth_estimator)] + (
            [("PoseNet", model.posenet)] if posenet else [])
        params = {name: {k: p.detach().clone() for k, p in net.named_parameters()}
                  for name, net in trained}
        before = _launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer[0]._mark("step_start")
        recording = recording_displacement(sweep_warp) if warm else contextlib.nullcontext([])
        try:
            with recording as calls:
                metrics = real_step(trainer, *args, **kw)
        finally:
            sweep_warp.plane_sweep_volume_backward_cuda = backward
            sweep_warp.plane_sweep_volume_pose_grad_cuda = pose_grad
        cap_disp.extend(calls)
        timer[0]._mark("step_end")
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n = tuple(a - b for a, b in zip(_launches(*counters), before))
        i = len(rows) + (0 if warm else 1)
        loss = float(metrics["loss"])
        check(math.isfinite(loss), f"{what} step {i}: loss {loss}")
        check(posenet == ("pose_loss" in metrics), f"{what} step {i}: metrics {sorted(metrics)}")
        pose_loss = float(metrics["pose_loss"]) if posenet else None
        check(not posenet or math.isfinite(pose_loss), f"{what} step {i}: pose loss {pose_loss}")
        check(n == per_step, f"{what} step {i}: gather, sweep, sweep backward, pose gradient, "
              f"displacement volume launched {n} times, expected {per_step}")
        state = model.flow_estimator.state_dict()
        for k, p in model.flow_estimator.named_parameters():
            check(torch.equal(p, dicl[k]), f"{what} step {i}: DICL parameter {k} moved")
        stale = [k for k in state if k.endswith("running_mean") and torch.equal(state[k], dicl[k])]
        check(not stale, f"{what} step {i}: DICL BN statistics did not move: {stale[:3]}")
        for name, net in trained:
            got_grad = [k for k, p in net.named_parameters() if p.grad is not None and p.grad.any()]
            still = [k for k in got_grad if torch.equal(dict(net.named_parameters())[k],
                                                        params[name][k])]
            check(got_grad, f"{what} step {i}: no {name} parameter got a gradient")
            check(not still, f"{what} step {i}: {name} parameters with a gradient did not "
                  f"move: {still[:3]}")
        if warm:
            for k in counters:
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
            log(f"{what}: warm-up step {ms:.1f} ms, loss {loss:.4f}; sweep backward "
                f"inputs {[tuple(a[0].shape) for a in captured]} {captured[0][0].dtype}; "
                f"displacement-volume inputs {_disp_shapes(cap_disp)}"
                + (f"; pose gradient inputs {[tuple(a[0].shape) for a in cap_pose]}"
                   if posenet else ""))
        else:
            rows.append(dict(ms=ms, loss=loss, **timer[0].stages_ms()))
            if posenet:
                rows[-1]["pose_loss"] = pose_loss
            extra = (f", PoseNet forward {rows[-1]['posenet']:.1f}" if posenet else "")
            log(f"{what}: step {i}: {ms:.1f} ms (prep {rows[-1]['prep']:.1f}, flow "
                f"{rows[-1]['flow']:.1f}, pose {rows[-1]['pose']:.1f}{extra}, depth forward "
                f"{rows[-1]['depth']:.1f}, loss + backward {rows[-1]['backward']:.1f}, Adam "
                f"{rows[-1]['adam']:.1f} ms device); loss {loss:.4f}"
                + (f" (pose loss {pose_loss:.4f})" if posenet else "")
                + f"; gather, sweep, sweep backward, pose gradient, displacement volume "
                f"launches {n}")
            if len(rows) == TRAIN_STEPS:
                rows.append(dict(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                 launches=_launches(*counters)))
        return metrics

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti_raw"
        n_test = 2
        t0 = time.perf_counter()
        write_kitti_raw_tree(root, n_frames=n_test + TRAIN_B * (TRAIN_STEPS + 1),
                             hw=(370, 1224), focal=K_KITTI[0][0], n_test=n_test)
        log(f"{what}: golden tree of {n_test + TRAIN_B * (TRAIN_STEPS + 1)} 370x1224 frames "
            f"rendered in {time.perf_counter() - t0:.2f} s")
        argv = ["--data", root, "--cfg", "kitti", "--gt-depth-dir", f"{root}/gt_depth",
                "--out", f"{tmp}/out", "--workers", "4", "-b", str(TRAIN_B), "--epochs", "1",
                "--override", f"data.train_size={TRAIN_HW}",
                *[f"{k}={v}" for k, v in BENCH_OVERRIDES.items()],
                *(["pose.estimator=POSENET"] if posenet else [])]
        log(f"{what}: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        for k in counters:
            k.launches = 0
        Trainer.train_step = timed_step
        try:
            t0 = time.perf_counter()
            history = cli.main(argv)
            wall = time.perf_counter() - t0
        finally:
            Trainer.train_step = real_step
        launches = _launches(*counters)
        check(os.path.exists(f"{tmp}/out/kitti/ckpt/0.pt"), f"{what}: no checkpoint written")
    check(len(rows) == TRAIN_STEPS + 1, f"{what}: {len(rows) - 1} timed steps, expected "
          f"{TRAIN_STEPS}")
    tail = rows.pop()
    check(tail["launches"] == tuple(TRAIN_STEPS * n for n in per_step),
          f"{what}: the timed steps launched {tail['launches']}")
    check(len(history) == 1 and all(math.isfinite(history[0][k]) for k in EIGEN_KEYS),
          f"{what}: validation {history}")
    mean = {k: sum(r[k] for r in rows) / TRAIN_STEPS for k in rows[0]}
    log(f"{what}: mean over {TRAIN_STEPS} steps at b = {TRAIN_B}, {TRAIN_HW[0]}x"
        f"{TRAIN_HW[1]}: {mean['ms']:.2f} ms/step ({1e3 * TRAIN_B / mean['ms']:.3f} pairs/s); "
        f"device stages prep {mean['prep']:.2f}, flow {mean['flow']:.2f}, pose "
        f"{mean['pose']:.2f}"
        + (f" (PoseNet forward {mean['posenet']:.2f})" if posenet else "")
        + f", depth forward {mean['depth']:.2f}, loss + backward "
        f"{mean['backward']:.2f}, Adam {mean['adam']:.2f} ms (step {mean['step']:.2f}); peak "
        f"memory {tail['peak_gib']:.2f} GiB; cli.main {wall:.2f} s; validation "
        f"{json.dumps({k: history[0][k] for k in sorted(EIGEN_KEYS)})}; launches after the "
        f"warm-up, validation included: {launches}")
    log(f"{what} rows: " + json.dumps(rows))
    return launches, captured, cap_pose, cap_disp


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), per element."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def phase_sweep_backward(captured, sweep_warp, camera):
    """The sweep backward kernel against its plain version on the inputs
    slice 5 gave it (the volume's bf16 gradient at b = 4, 64x192, 128
    planes), in bf16 and float32, and on a pose that puts the near planes
    behind the camera and one that pushes most samples out of the frame.

    Tolerance: the kernel sums dtgt with float32 atomics in another order
    than the plain version's index_add_, and dref plane by plane where torch
    sums pairwise: in float32 |kernel - plain| <= 1e-5 max|plain| + 1e-6; in
    bf16 that plus one bf16 ulp of the element (both float32 sums are cast to
    bf16 at the end). dtgt is exactly zero wherever no valid sample lands;
    dref is bit-identical across two launches."""
    dvol, depths, M, Kt = captured[0]
    B, D, H, W, C2 = dvol.shape
    C = C2 // 2
    ones = torch.ones((B, D, H, W, C2), device=dvol.device)
    variants = {"main path": Kt}
    behind, outward = Kt.clone(), Kt.clone()
    behind[:, 2] = -depths[D // 2]
    outward[:, 0] += 2 * W * depths[D // 4]
    variants.update({"behind the camera": behind, "out of frame": outward})
    max_err = 0.0
    for what, kt in variants.items():
        _, landed = camera.plane_sweep_volume_backward_plain(ones, depths, M, kt)
        empty = (landed == 0).all(dim=-1)
        x, y = camera.sweep_pixel_coords(depths, M, kt, H, W)
        invalid = float(((x < 0) | (x > W - 1) | (y < 0) | (y > H - 1)).float().mean())
        for dtype in (torch.bfloat16, torch.float32):
            dv = dvol.to(dtype)
            dref, dtgt = sweep_warp.plane_sweep_volume_backward_cuda(dv, depths, M, kt)
            dref2, _ = sweep_warp.plane_sweep_volume_backward_cuda(dv, depths, M, kt)
            pref, ptgt = camera.plane_sweep_volume_backward_plain(dv, depths, M, kt)
            name = f"sweep backward {what} {str(dtype)[6:]}"
            check(torch.equal(dref, dref2), f"{name}: dref differs between two launches")
            check((dtgt[empty] == 0).all(), f"{name}: dtgt nonzero where no sample lands")
            for half, got, want in (("dref", dref, pref), ("dtgt", dtgt, ptgt)):
                err = (got.float() - want.float()).abs()
                max_err = max(max_err, float(err.max()))
                tol = 1e-5 * float(want.float().abs().max()) + 1e-6
                if dtype == torch.bfloat16:
                    tol = tol + _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
                check(bool((err <= tol).all()), f"{name} {half}: max |kernel - plain| "
                      f"{float(err.max())} beyond tolerance")
            del dv, dref, dref2, dtgt, pref, ptgt
        log(f"sweep backward {what}: kernel within tolerance of plain in bf16 and float32, "
            f"dref bit-identical across launches; invalid samples {100 * invalid:.2f}%, "
            f"pixels no sample lands on {100 * float(empty.float().mean()):.2f}% (dtgt zero)")
    del ones, landed

    dref, dtgt = sweep_warp.plane_sweep_volume_backward_cuda(dvol, depths, M, Kt)
    work = backward_work(dvol, depths, M, Kt, sweep_warp, camera)

    def run():
        sweep_warp.plane_sweep_volume_backward_cuda(dvol, depths, M, Kt)

    ms = cuda_ms(run, reps=10)
    dev_ms = device_ms(run, "plane_sweep_volume_backward_kernel", reps=10)
    plain_ms = cuda_ms(lambda: camera.plane_sweep_volume_backward_plain(dvol, depths, M, Kt),
                       reps=2, warmup=1)
    yard = backward_yardstick(dvol, depths, M, Kt, camera)
    nbytes = sum(t.numel() * t.element_size() for t in (dvol, depths, M, Kt, dref, dtgt))
    samples = B * D * H * W
    flops = samples * (BWD_FLOPS_PER_SAMPLE + BWD_FLOPS_PER_CHANNEL * C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    call = dict(name="psnet_cost_volume_backward", dvol=list(dvol.shape),
                dtype=str(dvol.dtype).replace("torch.", ""), ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=yard["ms"], library_device_ms=yard["device_ms"],
                library_tgt_half_ms=yard["tgt_half_ms"],
                library_tgt_half_device_ms=yard["tgt_half_device_ms"],
                bound_ms=bound, bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_share=None if dev_ms is None else bound / dev_ms, bytes=nbytes,
                flops=flops, work=work)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"   # noqa: E731
    share = "not measured" if dev_ms is None else f"{100 * bound / dev_ms:.1f}%"
    half = yard["tgt_half_device_ms"]
    faster = ("not measured" if dev_ms is None or half is None
              else "yes" if dev_ms < half else "no")
    log(f"sweep backward kernel: dvol {tuple(dvol.shape)} {call['dtype']}: device "
        f"{fmt(dev_ms)}, events {ms:.4f} ms, plain {plain_ms:.4f} ms; yardstick "
        f"grid_sampler_2d_backward (tgt half) + sum(dim=1) (dref): events {yard['ms']:.4f} ms, "
        f"device {fmt(yard['device_ms'])}, the tgt half alone events "
        f"{yard['tgt_half_ms']:.4f} ms, device {fmt(half)}; bound {bound:.4f} ms "
        f"({call['bound_by']}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), share of bound "
        f"{share}; device time below the tgt half's: {faster}")
    return call, max_err


def backward_work(dvol, depths, M, Kt, sweep_warp, camera) -> dict:
    """The sweep backward's work mapping at these inputs: the kernel's own
    counts (a probe launch with the default mapping) of tile groups on the
    shared and the direct path, samples that left their box and 16-byte
    global reductions, which must equal the plain box rule's
    (`camera.sweep_backward_counts`), beside the scalar float32 atomics of
    the first design (4 per channel of a valid sample) and the distribution
    of box sizes."""
    B_, D_, H_, W_, C2 = dvol.shape
    C_ = C2 // 2
    plan = sweep_warp.backward_plan(C_, dvol.element_size())
    _, _, kernel_counts = sweep_warp.plane_sweep_volume_backward_probe(dvol, depths, M, Kt, plan)
    cap = plan[3] // (4 * C_)
    plain = camera.sweep_backward_counts(depths, M, Kt, H_, W_, C_, *plan[:3], cap)
    check(kernel_counts == plain, f"sweep backward work: kernel {kernel_counts} != plain {plain}")
    x, y = camera.sweep_pixel_coords(depths, M, Kt, H_, W_)
    valid = int(((x >= 0) & (x <= W_ - 1) & (y >= 0) & (y <= H_ - 1)).sum())
    box = camera.sweep_tap_box_plain(depths, M, Kt, H_, W_, *plan[:3], 10**9)
    area = (box["w"] * box["h"])[~box["direct"]].float()
    quant = ([] if area.numel() == 0 else
             torch.quantile(area, torch.tensor([0.0, 0.5, 0.9, 0.99, 1.0],
                                               device=area.device)).tolist())
    work = dict(plan=dict(zip(("tile_h", "tile_w", "planes", "smem_bytes"), plan)),
                box_pixels_fit=cap, **kernel_counts, first_design_atomics=4 * valid * C_,
                box_pixels_quantiles=dict(zip(("min", "p50", "p90", "p99", "max"), quant)))
    log(f"sweep backward work (tile {plan[0]}x{plan[1]}, {plan[2]} planes a group, "
        f"{plan[3] // 1024} KB = {cap} box pixels): {kernel_counts['shared_groups']} groups "
        f"shared, {kernel_counts['direct_groups']} direct, {kernel_counts['left_box_samples']} "
        f"samples left their box; {kernel_counts['global_reductions'] / 1e6:.2f} M 16-byte "
        f"global reductions against {4 * valid * C_ / 1e6:.0f} M scalar float32 atomics of "
        f"the first design; kernel counts == plain box rule's; box pixels "
        + ", ".join(f"{k} {v:.0f}" for k, v in work["box_pixels_quantiles"].items()))
    return work


def backward_yardstick(dvol, depths, M, Kt, camera) -> dict:
    """PyTorch's calls for the same gradient, which the port never makes:
    grid_sampler_2d_backward for the tgt half, on the same samples (NCHW
    input, the (B, D H, W, 2) grid normalized for align_corners, zeros
    padding), and the sum over the planes for dref. Events and device ms of
    both together and of the tgt half alone."""
    B_, D_, H_, W_, C2 = dvol.shape
    C_ = C2 // 2
    x, y = camera.sweep_pixel_coords(depths, M, Kt, H_, W_)
    valid = int(((x >= 0) & (x <= W_ - 1) & (y >= 0) & (y <= H_ - 1)).sum())
    grid = torch.stack([x / (W_ - 1) * 2 - 1, y / (H_ - 1) * 2 - 1], dim=-1)
    grid = grid.reshape(B_, D_ * H_, W_, 2).to(dvol.dtype)
    tgt_nchw = torch.zeros((B_, C_, H_, W_), dtype=dvol.dtype, device=dvol.device)
    gout = dvol[..., C_:].permute(0, 4, 1, 2, 3).reshape(B_, C_, D_ * H_, W_).contiguous()

    def tgt_half():
        torch.ops.aten.grid_sampler_2d_backward(gout, tgt_nchw, grid, 0, 0, True,
                                                [True, False])

    def both():
        tgt_half()
        dvol[..., :C_].sum(dim=1)

    def dev_ms(fn):
        return _profile_sums(_full_profile(fn, reps=10))[0]

    return {"ms": cuda_ms(both, reps=10), "device_ms": dev_ms(both),
            "tgt_half_ms": cuda_ms(tgt_half, reps=10), "tgt_half_device_ms": dev_ms(tgt_half)}


# slice 7: the pose tools on a golden KITTI VO tree at KITTI's odometry
# size (padded to 384x1280), and training from the poses they save
VO_HW, VO_TEST_FRAMES, VO_TRAIN_FRAMES = (370, 1226), 6, 3 * TRAIN_B + 1
# gather, sweep, sweep backward, pose gradient, displacement volume
RECORD_PER_PAIR = (0, 0, 0, 0, 2 * DISP_PER_PAIR)  # both directions' flow, no depth
LINK_PER_PAIR = (0, 0, 0, 0, DISP_PER_PAIR)        # one odometry link: the backward pose
PRED_POSE_PER_STEP = (0, SWEEP_PER_PAIR, 1, 0, 0)  # saved poses: no flow, no pose gradient
POSE_KEYS = {"rot_err", "trans_dist", "trans_angle", "rot_err_fw", "trans_dist_fw",
             "trans_angle_fw", "num_matches", "uniform_fallback"}
ODOMETRY_KEYS = {"ate_rmse", "t_err_pct", "r_err_deg_per_100m"}


class PoseStageTimer:
    """CUDA events at the flow network's entry and exit and at the model's
    exit, per call of the early-return pose forward: flow, then pose
    (sampler + RANSAC)."""

    def __init__(self, model):
        self.calls, self._ev = [], {}
        model.flow_estimator.register_forward_pre_hook(lambda m, a: self._mark("flow_start"))
        model.flow_estimator.register_forward_hook(lambda m, a, o: self._mark("flow_end"))
        model.register_forward_hook(lambda m, a, o: self._end())

    def _mark(self, key):
        self._ev[key] = torch.cuda.Event(enable_timing=True)
        self._ev[key].record()

    def _end(self):
        self._mark("end")
        self.calls.append(self._ev)
        self._ev = {}

    def take_ms(self):
        """{flow, pose} summed over the calls since the last take (after a
        synchronize)."""
        calls, self.calls = self.calls, []
        return {"flow": sum(e["flow_start"].elapsed_time(e["flow_end"]) for e in calls),
                "pose": sum(e["flow_end"].elapsed_time(e["end"]) for e in calls)}


def phase_cli_pose(dev, sweep_warp):
    """Slice 7's pose tools through `cli.main` on a golden KITTI VO tree
    rendered at 370x1226 (KITTI's focal; test sequences 9 and 10 of
    VO_TEST_FRAMES frames, train sequence 0 of VO_TRAIN_FRAMES), padded to
    384x1280, DICL flow, bf16, the slices' pose overrides:

    - `--record-pose`: the first pair (both directions) warms up, records
      the displacement volume's inputs, and the launch counts go to 0; each
      later pair must launch the displacement volume 10 times and the gather
      and the sweep no time; its host time around the synchronised pair and
      the CUDA-event split between flow and pose; the result has the six
      error keys, num_matches and uniform_fallback, all finite, and an
      odometry report per test sequence, each link of which launches the
      displacement volume 5 times;
    - `--save-pose`: pred_poses/{seq}_fw.npy and _bw.npy for every sequence
      of both splits, finite;
    - training with `pred_pose_online=False` on those poses, b = 4 at
      256x768: a warm-up step and two more, each launching the gather and
      the displacement volume no time and the sweep and its backward once,
      with a finite loss, on a batch whose pred_pose is the saved one.

    Returns ({path: launches (gather, sweep, sweep backward, pose gradient,
    displacement volume)} for the record run (odometry included) and the
    training run, the displacement volume's inputs of the warm-up pair)."""
    import numpy as np

    from deep_sfm_revisited_tpu_torch import cli
    from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_vo_tree
    from deep_sfm_revisited_tpu_torch.train.trainer import Trainer

    counters = (sweep_warp.KERNEL, sweep_warp.VOLUME, sweep_warp.VOLUME_BACKWARD,
                sweep_warp.VOLUME_POSE_GRAD, sweep_warp.DISPLACEMENT)
    real_make = cli.make_pose_forward
    rows, links, calls, cap_disp = [], [], [], []
    out = {}

    def make(model, diag=False):
        fwd = real_make(model, diag)
        if not diag:      # the odometry report: one backward pose per link
            def link(*args):
                before = _launches(*counters)
                pose = fwd(*args)
                links.append(tuple(a - b for a, b in zip(_launches(*counters), before)))
                return pose
            return link
        timer = PoseStageTimer(model)

        def counted(*args):   # record_pose_errors: backward, then forward, per pair
            if len(calls) % 2 == 0:
                torch.cuda.synchronize()
                calls.append((time.perf_counter(), _launches(*counters)))
            else:
                calls.append(None)
            warm = len(calls) <= 2
            with recording_displacement(sweep_warp) if warm else contextlib.nullcontext([]) as rec:
                result = fwd(*args)
            cap_disp.extend(rec)
            if len(calls) % 2 == 0:
                torch.cuda.synchronize()
                t0, before = calls[-2]
                ms = 1e3 * (time.perf_counter() - t0)
                n = tuple(a - b for a, b in zip(_launches(*counters), before))
                stages = timer.take_ms()
                pair = len(calls) // 2 - 1
                if pair == 0:
                    for k in counters:
                        k.launches = 0
                    log(f"cli record-pose: warm-up pair {ms:.1f} ms, launches {n}; "
                        f"displacement-volume inputs {_disp_shapes(cap_disp)}")
                    return result
                check(n == RECORD_PER_PAIR, f"cli record-pose: pair {pair} launched (gather, "
                      f"sweep, sweep backward, pose gradient, displacement volume) {n}, expected "
                      f"{RECORD_PER_PAIR}")
                rows.append(dict(ms=ms, **stages))
                log(f"cli record-pose: pair {pair}: {ms:.1f} ms (both directions; flow "
                    f"{stages['flow']:.1f}, pose {stages['pose']:.1f} ms device); launches {n}")
            return result
        return counted

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti_vo"
        t0 = time.perf_counter()
        write_kitti_vo_tree(root, seqs=(9, 10), n_frames=VO_TEST_FRAMES, hw=VO_HW,
                            focal=K_KITTI[0][0])
        write_kitti_vo_tree(root, seqs=(0,), n_frames=VO_TRAIN_FRAMES, hw=VO_HW,
                            focal=K_KITTI[0][0])
        log(f"cli pose: golden VO tree ({2 * VO_TEST_FRAMES} test, {VO_TRAIN_FRAMES} train "
            f"frames at {VO_HW[0]}x{VO_HW[1]}) rendered in {time.perf_counter() - t0:.2f} s")
        base = ["--data", root, "--cfg", "kitti", "--dataset", "kitti_vo", "--out",
                f"{tmp}/out", "--workers", "4"]
        bench = [f"{k}={v}" for k, v in BENCH_OVERRIDES.items()]
        argv = base + ["--record-pose", "--override", *bench]
        log("cli record-pose: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        for k in counters:
            k.launches = 0
        cli.make_pose_forward = make
        try:
            t0 = time.perf_counter()
            res = cli.main(argv)
            wall = time.perf_counter() - t0
        finally:
            cli.make_pose_forward = real_make
        out["cli_record_pose"] = _launches(*counters)
        check(len(rows) == VO_TEST_FRAMES * 2 - 1, f"cli record-pose: {len(rows)} timed pairs")
        check(POSE_KEYS <= set(res) and all(math.isfinite(res[k]) for k in POSE_KEYS),
              f"cli record-pose: result {res}")
        odo = res.get("odometry", {})
        check(sorted(odo) == [9, 10] and all(ODOMETRY_KEYS <= set(r) for r in odo.values())
              and all(math.isfinite(r["ate_rmse"]) for r in odo.values()),
              f"cli record-pose: odometry {odo}")
        check(len(links) == 2 * (VO_TEST_FRAMES - 1) and all(n == LINK_PER_PAIR for n in links),
              f"cli record-pose: odometry links launched {links}")
        mean = {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}
        log(f"cli record-pose: mean over {len(rows)} pairs after the warm-up: {mean['ms']:.2f} "
            f"ms/pair (both directions, {1e3 / mean['ms']:.3f} pairs/s); device flow "
            f"{mean['flow']:.2f}, pose {mean['pose']:.2f} ms; cli.main {wall:.2f} s (odometry "
            f"included); errors {json.dumps({k: res[k] for k in sorted(POSE_KEYS)})}")
        for seq, r in odo.items():
            log(f"cli record-pose: odometry seq {seq:02d}: " + json.dumps(
                {k: r[k] for k in ("ate_rmse", "rpe_trans", "rpe_rot_deg", "t_err_pct",
                                   "r_err_deg_per_100m", "frames_scored")})
                + " (t_err, r_err: NaN where the path is shorter than KITTI's shortest "
                  "segment, 100 m)")
        log("cli record-pose rows: " + json.dumps(rows))

        argv = base + ["--save-pose", "--override", *bench]
        t0 = time.perf_counter()
        written = cli.main(argv)
        log(f"cli save-pose: cli.main {time.perf_counter() - t0:.2f} s, sequences {written}")
        for seq, n in ((0, VO_TRAIN_FRAMES), (9, VO_TEST_FRAMES), (10, VO_TEST_FRAMES)):
            for d in ("fw", "bw"):
                path = f"{root}/pred_poses/{seq:02d}_{d}.npy"
                check(os.path.exists(path), f"cli save-pose: {path} missing")
                arr = np.load(path)
                check(arr.shape == (n, 3, 4) and np.isfinite(arr).all()
                      and (np.abs(arr).max(axis=(1, 2)) > 0).all(),
                      f"cli save-pose: {path} {arr.shape}, or a frame without a pose")
        saved_bw = np.load(f"{root}/pred_poses/00_bw.npy")

        real_step, steps = Trainer.train_step, []

        def counted_step(trainer, batch, *args, **kw):
            before = _launches(*counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = real_step(trainer, batch, *args, **kw)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            n = tuple(a - b for a, b in zip(_launches(*counters), before))
            loss = float(metrics["loss"])
            pred = batch["pred_pose"].float().cpu().numpy()
            check(math.isfinite(loss), f"cli pred-pose train: loss {loss}")
            check(n == PRED_POSE_PER_STEP, f"cli pred-pose train: step launched {n}, expected "
                  f"{PRED_POSE_PER_STEP}")
            check(all(np.isclose(pred[b], saved_bw, atol=0).all(axis=(1, 2)).any()
                      for b in range(len(pred))),
                  "cli pred-pose train: a batch pose is none of the saved ones")
            if not steps:
                for k in counters:
                    k.launches = 0
            steps.append(ms)
            log(f"cli pred-pose train: step {len(steps) - 1}{' (warm-up)' if len(steps) == 1 else ''}"
                f": {ms:.1f} ms, loss {loss:.4f}, launches {n}")
            return metrics

        argv = base + ["-b", str(TRAIN_B), "--epochs", "1", "--override",
                       f"data.train_size={TRAIN_HW}", "pred_pose_online=False", *bench]
        log("cli pred-pose train: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        Trainer.train_step = counted_step
        try:
            history = cli.main(argv)
        finally:
            Trainer.train_step = real_step
        check(len(steps) == 3, f"cli pred-pose train: {len(steps)} steps, expected 3")
        check(len(history) == 1 and math.isfinite(history[0]["train_loss"]),
              f"cli pred-pose train: {history}")
        out["cli_pred_pose_train"] = _launches(*counters)
        log(f"cli pred-pose train: {len(steps) - 1} steps after the warm-up, "
            f"{sum(steps[1:]) / (len(steps) - 1):.2f} ms/step; launches after the warm-up, "
            f"validation included: {out['cli_pred_pose_train']}")
    return out, cap_disp


# DICL's displacement volume: per output element the two mask products;
# per sample of a warped level the coordinate sums (2) and, per channel,
# the gather's blend (B1_FLOPS_PER_OUTPUT)
DISP_FLOPS_PER_OUTPUT, DISP_FLOPS_PER_SAMPLE = 2, 2
DISP_FUSES = "deep_sfm_revisited_tpu/models/dicl.py:160 (shifted_pairs), :231 (warp_flow)"


def phase_displacement(captured, sweep_warp, dicl, old_source: str | None = None):
    """B1's displacement-volume kernel against its plain version (the
    composition it replaced, `shifted_pairs` of `warp_flow`, with the
    gather's plain version) on the inputs that slice 1's pair, the training
    step and the `--record-pose` pair gave it (`captured`: {path: [(x, y,
    flow or None, md)]}), in bf16 and float32, and two launches on the same
    inputs; then per level of slice 1's pair and of the training step, as
    the main path ran them: the work mapping, device and events ms, the
    bound and share of it, the plain version's time, and the device time
    and kernel count of the composition it replaced (the card's gather,
    then the eager stack). With `old_source`, an earlier `sweep_warp.cu`
    (`old_displacement_volume`), held to the plain version too, is timed
    beside it level by level in turns (old, new, new, old), device and
    events ms.

    Tolerance: exact -- the samples take B1's taps and blend rounded op by
    op, and the masks are 0 or 1, so the stack equals the composition's bit
    for bit (`torch.equal`)."""
    max_err = 0.0
    for path, calls in captured.items():
        for i, (x, y, flow, md) in enumerate(calls):
            for dtype in (torch.bfloat16, torch.float32):
                xd, yd = x.to(dtype), y.to(dtype)
                got = sweep_warp.displacement_volume_cuda(xd, yd, flow, md)
                again = sweep_warp.displacement_volume_cuda(xd, yd, flow, md)
                want = dicl.displacement_volume_plain(xd, yd, flow, md)
                name = f"displacement volume {path} call {i} {tuple(x.shape)} {str(dtype)[6:]}"
                check(torch.equal(got, again), f"{name}: differs between two launches")
                err = float((got.float() - want.float()).abs().max())
                max_err = max(max_err, err)
                check(got.shape == want.shape and torch.equal(got, want),
                      f"{name}: max |kernel - plain| = {err}")
                del got, again, want
        log(f"displacement volume {path}: {len(calls)} calls {_disp_shapes(calls)}: kernel == "
            "plain in bf16 and float32, bit-identical across launches")

    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"   # noqa: E731
    old_kernel = None if old_source is None else old_displacement_volume(Path(old_source))
    out = {}
    for path in ("dicl_main_path", "cli_train"):
        rows = []
        for x, y, flow, md in captured[path][:DISP_PER_PAIR]:
            def run():
                return sweep_warp.displacement_volume_cuda(x, y, flow, md)

            def old():
                return dicl.shifted_pairs(x, y if flow is None else dicl.warp_flow(y, flow), md)

            vol = run()
            check(torch.equal(old(), vol), f"{path}: the replaced composition differs")
            ms = cuda_ms(run, reps=20)
            dev_ms = device_ms(run, "displacement_volume")
            plain_ms = cuda_ms(lambda: dicl.displacement_volume_plain(x, y, flow, md), reps=3,
                               warmup=1)
            old_ms = cuda_ms(old, reps=5)
            old_dev_ms, old_kernels = _profile_sums(_full_profile(old, reps=5))
            ins = (x, y) if flow is None else (x, y, flow)
            nbytes = sum(t.numel() * t.element_size() for t in ins + (vol,))
            flops = DISP_FLOPS_PER_OUTPUT * vol.numel() + (0 if flow is None else (
                DISP_FLOPS_PER_SAMPLE * flow[:, 0].numel() + B1_FLOPS_PER_OUTPUT * y.numel()))
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
            bound = max(t_bytes, t_ops)
            turns = None
            if old_kernel is not None:
                check(torch.equal(old_kernel(x, y, flow, md), vol),
                      f"{path}: the earlier source's volume differs")
                runs = {"old": lambda: old_kernel(x, y, flow, md), "new": run}
                turns = {f"{who}_{k}": [] for who in runs for k in ("device_ms", "events_ms")}
                for who in ("old", "new", "new", "old"):
                    turns[f"{who}_device_ms"].append(
                        device_ms(runs[who], "displacement_volume", reps=20))
                    turns[f"{who}_events_ms"].append(cuda_ms(runs[who], reps=20))
            plan = sweep_warp.DISPLACEMENT.plan(x, y, md)
            rows.append(dict(name=f"{path}_level_{tuple(x.shape[-2:])}", x=list(x.shape), md=md,
                             plan=vars(plan), in_turns=turns, flow=flow is not None,
                             out=list(vol.shape),
                             dtype=str(x.dtype).replace("torch.", ""), ms=ms, device_ms=dev_ms,
                             plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                             bound_by="bytes" if t_bytes >= t_ops else "operations",
                             bound_share=None if dev_ms is None else bound / dev_ms,
                             bytes=nbytes, flops=flops, old_composition_ms=old_ms,
                             old_composition_device_ms=old_dev_ms,
                             old_composition_kernels=old_kernels))
            share = "not measured" if dev_ms is None else f"{100 * bound / dev_ms:.1f}%"
            log(f"displacement volume {path} x {tuple(x.shape)} md {md} "
                f"{'with' if flow is not None else 'without'} flow -> {tuple(vol.shape)} "
                f"{rows[-1]['dtype']}: device {fmt(dev_ms)}, events {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({rows[-1]['bound_by']}, "
                f"{nbytes / 1e6:.1f} MB), share of bound {share}; the replaced composition "
                f"device {fmt(old_dev_ms)} in {old_kernels} kernels, events {old_ms:.4f} ms; "
                f"plan {vars(plan)}"
                + ("" if turns is None else f"; in turns with {old_source}: {json.dumps(turns)}"))
            del vol
        total = _pair_sums(rows)
        for key in ("old_composition_ms", "old_composition_kernels",
                    "old_composition_device_ms"):
            total[key] = _sum_or_none(r[key] for r in rows)
        total["bound_share"] = (None if total["device_ms"] is None
                                else total["bound_ms"] / total["device_ms"])
        if old_kernel is not None:   # per pair or step, turn by turn
            total["in_turns"] = {k: [_sum_or_none(r["in_turns"][k][t] for r in rows)
                                     for t in range(2)] for k in rows[0]["in_turns"]}
            log(f"displacement volume per {'pair' if path == 'dicl_main_path' else 'step'} in "
                f"turns (old, new, new, old) with {old_source}: {json.dumps(total['in_turns'])}")
        out[path] = dict(total, calls=rows)
        log(f"displacement volume per {'pair' if path == 'dicl_main_path' else 'step'} "
            f"({path}): device {fmt(total['device_ms'])}, events {total['ms']:.4f} ms, bound "
            f"{total['bound_ms']:.4f} ms, plain {total['plain_ms']:.4f} ms; the replaced "
            f"composition device {fmt(total['old_composition_device_ms'])} in "
            f"{total['old_composition_kernels']} kernels")
    return out, max_err


POSE_GRAD_REPLACES = "deep_sfm_revisited_tpu/models/psnet.py:253"
# the pose gradient: per (b, d, y, x) the point, divide and taps (14); per
# valid sample the float64 chain to dp and the plane sums (16) and, per
# channel, the four tap differences, their weights, the two sums and the
# two products with dvol and their accumulation (14). An invalid sample
# reads no dvol and adds nothing.
POSE_GRAD_FLOPS_PER_SAMPLE, POSE_GRAD_FLOPS_PER_VALID, POSE_GRAD_FLOPS_PER_CHANNEL = 14, 16, 14


def old_pose_grad_kernel(path: Path):
    """The sweep pose gradient of an earlier `sweep_warp.cu`, built by
    `ops/cuda/build.py` beside the current source and called through its
    plain C entry point with ctypes (an earlier `_blocks` entry may take no
    plane count; the source says which)."""
    import ctypes

    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    takes_d = "pose_grad_blocks(int B, int D," in path.read_text()

    class OldPoseGrad(CudaKernel):
        source = str(path.resolve())   # an absolute path replaces csrc/

        def _bind(self, lib):
            blocks = lib.dsfm_plane_sweep_volume_pose_grad_blocks
            blocks.argtypes = [ctypes.c_int] * (6 if takes_d else 5)
            blocks.restype = ctypes.c_longlong
            fn = lib.dsfm_plane_sweep_volume_pose_grad
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

        def __call__(self, dvol, tgt, depths, M, Kt):
            lib = self.build()
            B_, D_, H_, W_, C2 = dvol.shape
            code = {torch.float32: 0, torch.bfloat16: 1}[dvol.dtype]
            dims = (B_, D_, H_, W_, C2 // 2) if takes_d else (B_, H_, W_, C2 // 2)
            n = lib.dsfm_plane_sweep_volume_pose_grad_blocks(*dims, code)
            check(n > 0, f"the earlier pose gradient refuses {tuple(dvol.shape)}")
            partial = torch.empty((n, 12), dtype=torch.float64, device=dvol.device)
            dM = torch.zeros((B_, 3, 3), device=dvol.device)
            dKt = torch.zeros((B_, 3), device=dvol.device)
            err = lib.dsfm_plane_sweep_volume_pose_grad(
                dvol.data_ptr(), tgt.data_ptr(), depths.data_ptr(), M.data_ptr(), Kt.data_ptr(),
                partial.data_ptr(), dM.data_ptr(), dKt.data_ptr(), B_, D_, H_, W_, C2 // 2, code,
                torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"the earlier pose gradient's launch failed: cudaError {err}")
            return dM, dKt

    return OldPoseGrad()


def old_displacement_backward(path: Path):
    """The displacement volume's backward of an earlier `sweep_warp.cu` whose
    entry point takes a hole buffer (the first kernel, two launches), built
    by `ops/cuda/build.py` beside the current source and called through its
    plain C entry point with ctypes, with the scratch, the zero fill and the
    cast its operator made."""
    import ctypes

    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    check("void* hole" in path.read_text(),
          f"{path} has no displacement backward that takes a hole buffer")

    class OldDispBackward(CudaKernel):
        source = str(path.resolve())   # an absolute path replaces csrc/

        def _bind(self, lib):
            fn = lib.dsfm_displacement_volume_backward
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

        def __call__(self, dout, y, flow, md):
            lib = self.build()
            B_, C_, h, w = y.shape
            code = {torch.float32: 0, torch.bfloat16: 1}[y.dtype]
            hole = torch.empty((B_, h, w), dtype=torch.uint8, device=y.device)
            dx = torch.empty_like(y)
            acc = None if flow is None else torch.zeros(y.shape, device=y.device)
            dy = torch.empty_like(y) if flow is None else None
            err = lib.dsfm_displacement_volume_backward(
                dout.data_ptr(), y.data_ptr(), None if flow is None else flow.data_ptr(),
                hole.data_ptr(), dx.data_ptr(), None if dy is None else dy.data_ptr(),
                None if acc is None else acc.data_ptr(), B_, C_, h, w, md, code,
                torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"the earlier displacement backward's launch failed: cudaError {err}")
            return dx, (dy if acc is None else acc.to(y.dtype))

    return OldDispBackward()


def old_displacement_volume(path: Path):
    """DICL's displacement volume of an earlier `sweep_warp.cu` whose entry
    point chooses its own mapping (`..., int dtype, int pair_io, void*
    stream`), built by `ops/cuda/build.py` beside the current source and
    called through its plain C entry point with ctypes, with the output its
    operator allocated. Phase 14 and `b1_compare.py --volume` time it."""
    import ctypes

    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    check("int dtype, int pair_io, void* stream" in path.read_text(),
          f"{path} has no displacement volume that takes pair_io")

    class OldVolume(CudaKernel):
        source = str(path.resolve())   # an absolute path replaces csrc/

        def _bind(self, lib):
            fn = lib.dsfm_displacement_volume
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

        def __call__(self, x, y, flow, md):
            B_, C_, h, w = x.shape
            out = torch.empty((B_, (2 * md + 1) ** 2, 2 * C_, h, w), dtype=x.dtype,
                              device=x.device)
            pair_io = int(w % 2 == 0 and x.data_ptr() % (2 * x.element_size()) == 0)
            err = self.build().dsfm_displacement_volume(
                x.data_ptr(), y.data_ptr(), None if flow is None else flow.data_ptr(),
                out.data_ptr(), B_, C_, h, w, md, {torch.float32: 0, torch.bfloat16: 1}[x.dtype],
                pair_io, torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{path}'s displacement volume launch failed: cudaError {err}")
            return out

    return OldVolume()


def phase_pose_grad(cap_pose, sweep_warp, camera, old_source: str | None = None):
    """The sweep pose-gradient kernel against its plain version on the
    inputs slice 7's POSENET step gave it (the volume's bf16 gradient at
    b = 4, 64x192, 128 planes, and the target features), in bf16 and
    float32, and on a pose that puts the near planes behind the camera, one
    that pushes most samples out of the frame and one with every plane
    behind it (exactly zero).

    With `old_source`, an earlier `sweep_warp.cu` (`old_pose_grad_kernel`),
    its pose gradient is held to the same tolerance and timed beside the
    current one in turns (old, new, new, old) on the main path's inputs.

    Tolerance: the kernel sums the per-sample float32 terms in float64 in a
    fixed order, the plain version in torch's: |kernel - plain| <= 1e-5
    max|plain|. dM and dK t are bit-identical across two launches."""
    dvol, tgt, depths, M, Kt = cap_pose[0]
    B_, D_, H_, W_, C2 = dvol.shape
    C_ = C2 // 2
    behind, outward, none = Kt.clone(), Kt.clone(), Kt.clone()
    behind[:, 2] = -depths[D_ // 2]
    outward[:, 0] += 2 * W_ * depths[D_ // 4]
    none[:, 2] = -1e4
    variants = {"main path": Kt, "behind the camera": behind, "out of frame": outward,
                "no valid sample": none}
    max_err = 0.0
    for what, kt in variants.items():
        x, y = camera.sweep_pixel_coords(depths, M, kt, H_, W_)
        invalid = float(((x < 0) | (x > W_ - 1) | (y < 0) | (y > H_ - 1)).float().mean())
        for dtype in (torch.bfloat16, torch.float32):
            dv, tg = dvol.to(dtype), tgt.to(dtype)
            first = sweep_warp.plane_sweep_volume_pose_grad_cuda(dv, tg, depths, M, kt)
            second = sweep_warp.plane_sweep_volume_pose_grad_cuda(dv, tg, depths, M, kt)
            plain = camera.plane_sweep_volume_pose_grad_plain(dv, tg, depths, M, kt)
            name = f"sweep pose gradient {what} {str(dtype)[6:]}"
            for got, again, want in zip(first, second, plain):
                check(torch.equal(got, again), f"{name}: differs between two launches")
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                if what == "no valid sample":
                    check(scale == 0 and float(got.abs().max()) == 0, f"{name}: not zero")
                    continue
                max_err = max(max_err, err)
                check(scale > 0 and err <= 1e-5 * scale, f"{name}: max |kernel - plain| "
                      f"{err} against max |plain| {scale}")
            del dv, tg
        log(f"sweep pose gradient {what}: kernel within 1e-5 of plain in bf16 and float32, "
            f"bit-identical across launches; invalid samples {100 * invalid:.2f}%")

    dM, dKt = sweep_warp.plane_sweep_volume_pose_grad_cuda(dvol, tgt, depths, M, Kt)

    def run():
        sweep_warp.plane_sweep_volume_pose_grad_cuda(dvol, tgt, depths, M, Kt)

    ms = cuda_ms(run, reps=10)
    dev_ms = device_ms(run, "plane_sweep_pose_grad", reps=10)
    plain_ms = cuda_ms(lambda: camera.plane_sweep_volume_pose_grad_plain(dvol, tgt, depths, M,
                                                                          Kt),
                       reps=2, warmup=1)
    x, y = camera.sweep_pixel_coords(depths, M, Kt, H_, W_)
    valid = int(((x >= 0) & (x <= W_ - 1) & (y >= 0) & (y <= H_ - 1)).sum())
    grid = torch.stack([x / (W_ - 1) * 2 - 1, y / (H_ - 1) * 2 - 1], dim=-1)
    grid = grid.reshape(B_, D_ * H_, W_, 2).to(dvol.dtype)
    tgt_nchw = tgt.permute(0, 3, 1, 2).contiguous()
    gout = dvol[..., C_:].permute(0, 4, 1, 2, 3).reshape(B_, C_, D_ * H_, W_).contiguous()

    def yardstick():
        torch.ops.aten.grid_sampler_2d_backward(gout, tgt_nchw, grid, 0, 0, True,
                                                [False, True])

    lib_ms = cuda_ms(yardstick, reps=10)
    lib_dev = _profile_sums(_full_profile(yardstick, reps=10))[0]
    del grid, gout, tgt_nchw, x, y
    in_turns = None
    if old_source:
        old = old_pose_grad_kernel(Path(old_source))
        want = camera.plane_sweep_volume_pose_grad_plain(dvol, tgt, depths, M, Kt)
        for got, w in zip(old(dvol, tgt, depths, M, Kt), want):
            check(float((got - w).abs().max()) <= 1e-5 * float(w.abs().max()),
                  "the earlier pose gradient is not within 1e-5 of the plain version")
        runs = {"old": lambda: old(dvol, tgt, depths, M, Kt), "new": run}
        in_turns = {f"{who}_{k}": [] for who in runs for k in ("device_ms", "events_ms")}
        for who in ("old", "new", "new", "old"):
            in_turns[f"{who}_device_ms"].append(device_ms(runs[who], "plane_sweep_pose_grad",
                                                          reps=10))
            in_turns[f"{who}_events_ms"].append(cuda_ms(runs[who], reps=10))
        log(f"sweep pose gradient in turns (old, new, new, old) against {old_source}: "
            + json.dumps(in_turns))
    else:
        log("sweep pose gradient: no earlier source given (--old-b1), no timing in turns")
    # the least work of any implementation: dvol's tgt half read only where
    # the sample is valid (validity follows from M, K t and the depths
    # alone), the other inputs read once, dM and dK t written once
    samples = B_ * D_ * H_ * W_
    nbytes = valid * C_ * dvol.element_size() + sum(
        t.numel() * t.element_size() for t in (tgt, depths, M, Kt, dM, dKt))
    flops = (samples * POSE_GRAD_FLOPS_PER_SAMPLE
             + valid * (POSE_GRAD_FLOPS_PER_VALID + POSE_GRAD_FLOPS_PER_CHANNEL * C_))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    call = dict(name="plane_sweep_volume_pose_grad", dvol=list(dvol.shape),
                dtype=str(dvol.dtype).replace("torch.", ""), ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev,
                bound_ms=bound, bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_share=None if dev_ms is None else bound / dev_ms, bytes=nbytes,
                flops=flops, valid_share=valid / samples, in_turns=in_turns)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"   # noqa: E731
    share = "not measured" if dev_ms is None else f"{100 * bound / dev_ms:.1f}%"
    log(f"sweep pose gradient kernel: dvol {tuple(dvol.shape)} {call['dtype']}: device "
        f"{fmt(dev_ms)}, events {ms:.4f} ms, plain {plain_ms:.4f} ms; yardstick "
        f"grid_sampler_2d_backward (the grid's gradient alone): events {lib_ms:.4f} ms, device "
        f"{fmt(lib_dev)}; bound {bound:.4f} ms ({call['bound_by']}, {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP, valid samples {100 * valid / samples:.2f}%), share of bound "
        f"{share}")
    return call, max_err


# slice 9: DICL flow pretraining through `cli --train-flow` on a KITTI 2015
# flow tree at KITTI's size, cropped to the depth recipe's 256x768 (both
# sides multiples of 128: DICL pads its input to /128, the flow GT is not
# padded, so KITTIFlow's default 288x960 crop is refused, as in JAX)
FLOW_HW, FLOW_CROP, FLOW_STEPS = (375, 1242), (256, 768), 5
FLOW_PAIRS = TRAIN_B * (FLOW_STEPS + 1)
# gather, sweep, sweep backward, pose gradient, displacement volume, its backward
FLOW_PER_STEP = (0, 0, 0, 0, DISP_PER_PAIR, DISP_PER_PAIR)
DISP_BWD_REPLACES = "deep_sfm_revisited_tpu/models/dicl.py:160"
# the displacement backward: one add per dout element it must read; per
# (b, c, pixel) of a warped level whose hole flag is set the four weighted
# taps (a weight product and a scaled add each, 3); per (b, pixel) the hole
# flag's recomputed sample (the forward's blend per channel, at most C)
DISP_BWD_FLOPS_PER_READ, DISP_BWD_FLOPS_PER_TAP = 1, 3


@contextlib.contextmanager
def dicl_relus(dicl, fn):
    """Within the block, every ReLU of `models/dicl.py` (its modules call
    `F.relu`) goes through fn(x), whose value is the ReLU's output."""
    real = dicl.F
    ns = type("F", (), {k: staticmethod(getattr(real, k)) for k in dir(real)
                        if not k.startswith("__") and callable(getattr(real, k))})
    ns.relu = staticmethod(fn)
    dicl.F = ns
    try:
        yield
    finally:
        dicl.F = real


def phase_small_flow_train_reference(dev) -> None:
    """One DICL flow-pretraining step (`train/flow_trainer.py::FlowTrainer`,
    the recipe's flow config, float32, TF32 off) at 128x128 on the card
    against the same step on the CPU (plain versions, the displacement
    volume's backward by autograd of its plain composition), from the same
    weights and batch: the loss and EPE to 1e-4 relative; DICL's clipped
    gradients, all tensors together, to twice the largest relative move
    (L2) the CPU's own gradients make under rounding-sized changes of the
    input, and 1 - cosine <= 1e-4. The input changes: the reference image
    scaled by 1 + 1e-6, 1 - 1e-6 and 1 + 3e-6 (as phase 8), and plus +-1e-7
    and +-3e-7 times a fixed noise image (about one float32 ulp: train-mode
    BN normalizes a scaling away, not noise).

    Tensor by tensor the card is held through the witness, as phase 8's: at
    random weights a float32 ReLU within rounding of zero switches between
    devices and moves a tensor's gradient by a sizeable share of its
    largest element, and which units switch differs from one change of the
    input to the next (a first run: context3's gradients 1.4e-1 apart on
    the card, within 5e-4 at all seven CPU changes, 7.6e-6 with the card's
    ReLU masks), so a per-tensor bound from the CPU's own moves does not
    hold. The inputs of every ReLU are recorded on both devices; the units
    of other sign must have inputs within 1e-4 of their tensor's largest,
    and the CPU step rerun with the card's ReLU masks must give every
    gradient within 1e-3 of its largest element of the card's (the scale
    floored at 1e-3 of the largest element of all: the matching nets' last
    biases have a zero true gradient, the softmax over displacements being
    blind to a shift, and carry rounding alone). The per-tensor moves
    against twice the CPU's are logged. The card's step must launch the
    displacement volume and its backward 5 times each."""
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.models import dicl
    from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp
    from deep_sfm_revisited_tpu_torch.train.flow_trainer import FlowTrainer, build_flow_model

    what = "small flow-train reference"
    cfg = SfMConfig.kitti().override(**{"train.mixed_prec": False})
    h = w = 128
    g = torch.Generator().manual_seed(11)
    ref = torch.rand((1, h, w, 3), generator=g) * 2 - 1
    batch = {"ref": ref,
             "target": torch.roll(ref, (2, 3), dims=(1, 2))
             + 0.05 * torch.randn((1, h, w, 3), generator=g),
             "flow_gt": torch.tensor([3.0, 2.0]) + torch.randn((1, h, w, 2), generator=g),
             "flow_valid": torch.rand((1, h, w), generator=g) < 0.7}
    noise = torch.randn((1, h, w, 3), generator=g)

    def step(device, scale=1.0, eps=0.0, relu=F.relu):
        t = FlowTrainer(build_flow_model(cfg.flow, seed=3).to(device), cfg, total_steps=40)
        b = {k: v.to(device) for k, v in
             dict(batch, ref=batch["ref"] * scale + eps * noise).items()}
        with dicl_relus(dicl, relu):
            m = t.train_step(b)
        return ({k: float(v) for k, v in m.items()},
                {k: p.grad.detach().cpu() for k, p in t.model.named_parameters()})

    def recorder(out):
        def relu(x):
            out.append(x.detach().cpu())
            return F.relu(x)
        return relu

    def report(got, want):
        # _grad_report with each tensor's scale floored at 1e-3 of the
        # largest element of all the gradients: the matching nets' last
        # biases shift every displacement's cost alike, to which the
        # softmax is blind, so their true gradient is zero and what either
        # device computes is rounding (0 to 1e-9 against 2e-2 on the CPU;
        # the smallest other tensor's largest element is 3e-3 of 2e-2)
        floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
        errs = {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), floor)
                for k, w in want.items()}
        g = torch.cat([got[k].double().flatten() for k in want])
        w = torch.cat([want[k].double().flatten() for k in want])
        return errs, _grad_report(got, want)[1], float((g - w).norm() / w.norm())

    counters = (sweep_warp.DISPLACEMENT, sweep_warp.DISPLACEMENT_BACKWARD)
    before = _launches(*counters)
    card_relu, cpu_relu = [], []
    m_card, g_card = step(dev, relu=recorder(card_relu))
    torch.cuda.synchronize()
    n = tuple(a - b for a, b in zip(_launches(*counters), before))
    check(n == (DISP_PER_PAIR, DISP_PER_PAIR), f"{what}: the displacement volume and its "
          f"backward launched {n} times, expected {(DISP_PER_PAIR,) * 2}")
    m_cpu, g_cpu = step("cpu", relu=recorder(cpu_relu))
    self_errs, self_cos, self_l2 = {}, 0.0, 0.0
    for kw in (dict(scale=1 + 1e-6), dict(scale=1 - 1e-6), dict(scale=1 + 3e-6),
               dict(eps=1e-7), dict(eps=-1e-7), dict(eps=3e-7), dict(eps=-3e-7)):
        e, c, l2 = report(step("cpu", **kw)[1], g_cpu)
        self_errs = {k: max(v, self_errs.get(k, 0.0)) for k, v in e.items()}
        self_cos, self_l2 = max(self_cos, c), max(self_l2, l2)
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in ("loss", "epe")}
    errs, cos_err, l2_err = report(g_card, g_cpu)
    worst = max(errs, key=errs.get)
    bounds = {k: max(1e-3, 2 * v) for k, v in self_errs.items()}
    over = [k for k in errs if errs[k] > bounds[k]]
    log(f"{what}: loss card {m_card['loss']:.7f} vs cpu {m_cpu['loss']:.7f} (relative "
        f"{rel['loss']:.2e}), EPE {m_card['epe']:.6f} vs {m_cpu['epe']:.6f} (relative "
        f"{rel['epe']:.2e}); DICL gradients: {sum(e <= 1e-3 for e in errs.values())}/"
        f"{len(errs)} tensors within 1e-3 of their max, worst {errs[worst]:.2e} ({worst}), "
        f"relative L2 {l2_err:.2e}, 1 - cosine {cos_err:.2e}; the CPU against itself at "
        f"seven perturbed inputs: worst {max(self_errs.values()):.2e}, "
        f"{sum(e > 1e-3 for e in self_errs.values())} tensors beyond 1e-3, relative L2 "
        f"{self_l2:.2e}, 1 - cosine {self_cos:.2e}; tensors beyond twice the CPU's own move: "
        f"{len(over)} ({', '.join(f'{k} {errs[k]:.2e} > {bounds[k]:.2e}' for k in over[:3])}); "
        f"launches (volume, backward) {n}")
    check(len(card_relu) == len(cpu_relu) and all(
        a.shape == b.shape for a, b in zip(card_relu, cpu_relu)),
        f"{what}: the ReLUs ran in another order on the card than on the CPU")
    flips = []          # (call, units of other sign, largest such |input| / max |input|)
    for i, (xc, xp) in enumerate(zip(card_relu, cpu_relu)):
        other = (xc > 0) != (xp > 0)
        if other.any():
            near = torch.maximum(xc.abs(), xp.abs())[other].max()
            flips.append((i, int(other.sum()), float(near / xp.abs().max())))
    masks = iter([(x > 0).float() for x in card_relu])
    _, g_forced = step("cpu", relu=lambda x: x * next(masks))
    f_errs, f_cos, _ = report(g_card, g_forced)
    f_worst = max(f_errs, key=f_errs.get)
    log(f"{what}: ReLU units of other sign on the card than on the CPU: "
        f"{sum(f[1] for f in flips)} in {len(flips)} of {len(card_relu)} ReLU calls, their "
        f"largest input {max((f[2] for f in flips), default=0.0):.2e} of its tensor's max; "
        f"the CPU step with the card's ReLU masks: worst {f_errs[f_worst]:.2e} ({f_worst}), "
        f"{worst} {f_errs[worst]:.2e}, 1 - cosine {f_cos:.2e}")
    check(all(math.isfinite(v) for v in m_card.values()), f"{what}: metrics {m_card}")
    check(max(rel.values()) <= 1e-4, f"{what}: loss or EPE differs: {rel}")
    check(all(f[2] <= 1e-4 for f in flips), f"{what}: a ReLU unit of other sign on the card "
          f"has an input beyond 1e-4 of its tensor's max: "
          f"{max(flips, key=lambda f: f[2], default=None)}")
    check(f_errs[f_worst] <= 1e-3, f"{what}: with the card's ReLU masks the CPU gradient "
          f"{f_worst} still differs by {f_errs[f_worst]} of its max, beyond 1e-3")
    check(l2_err <= 2 * self_l2, f"{what}: the gradients differ by {l2_err} (relative L2), "
          f"beyond twice the CPU's own {self_l2}")
    check(cos_err <= 1e-4, f"{what}: 1 - cosine of the gradients {cos_err}")


class FlowStageTimer:
    """CUDA events around one flow-training step: for DICL the feature net
    (the U-net's two calls, one per frame) and the levels (the feature
    net's exit to DICL's), for PWC-DC the forward (the step's start to
    PWC-DC's exit); the loss and backward (the flow net's exit to the
    optimizer's step, clipping and the schedule included) and the AdamW
    update."""

    def __init__(self, trainer):
        self.events, self._feature_calls = {}, 0
        model = trainer.model
        if hasattr(model, "feature"):
            model.feature.register_forward_pre_hook(lambda m, a: self._feature(True))
            model.feature.register_forward_hook(lambda m, a, o: self._feature(False))
        model.register_forward_hook(lambda m, a, o: self._mark("flow_end"))
        trainer.optimizer.register_step_pre_hook(lambda o, a, k: self._mark("opt_start"))
        trainer.optimizer.register_step_post_hook(lambda o, a, k: self._mark("opt_end"))

    def _feature(self, entry):
        if entry and self._feature_calls % 2 == 0:
            self._mark("feature_start")
        if not entry:
            self._feature_calls += 1
            if self._feature_calls % 2 == 0:
                self._mark("feature_end")

    def _mark(self, key):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[key] = ev

    def stages_ms(self):
        e = self.events
        out = ({"feature": e["feature_start"].elapsed_time(e["feature_end"]),
                "levels": e["feature_end"].elapsed_time(e["flow_end"])} if "feature_start" in e
               else {"forward": e["step_start"].elapsed_time(e["flow_end"])})
        return dict(out, loss_backward=e["flow_end"].elapsed_time(e["opt_start"]),
                    optimizer=e["opt_start"].elapsed_time(e["opt_end"]),
                    step=e["step_start"].elapsed_time(e["step_end"]))


def phase_cli_train_flow(dev, sweep_warp):
    """Slice 9 through `cli.main --train-flow` on a KITTI 2015 flow tree
    rendered at 375x1242 (`data/synthetic.py::write_kitti_flow_tree`:
    consecutive views of the analytic scene, their exact flow in KITTI's
    16-bit format with a sparse valid mask), FLOW_PAIRS pairs, cropped to
    256x768, b = 4, one epoch, DICL at the recipe's widths, bf16: one
    warm-up step, which records the displacement volume's inputs and its
    backward's gradients, then FLOW_STEPS timed steps with the launch
    counts reset after the warm-up, each of which must launch the
    displacement volume and its backward 5 times each and no other kernel,
    give a finite loss and EPE, move DICL's parameters that got a gradient
    and every BN running mean; ms/step, the stage split and peak memory;
    then the epoch's validation (EPE and Fl-all, finite) and checkpoint,
    which `--pretrained-flow` restores into an SFMNet with every DICL
    tensor equal. Returns (launches over the timed steps and the
    validation, [(dout, x, y, flow, md)] of the warm-up's five levels)."""
    from deep_sfm_revisited_tpu_torch import cli
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_flow_tree
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
    from deep_sfm_revisited_tpu_torch.train.flow_trainer import FlowTrainer

    what = "cli train-flow"
    counters = (sweep_warp.KERNEL, sweep_warp.VOLUME, sweep_warp.VOLUME_BACKWARD,
                sweep_warp.VOLUME_POSE_GRAD, sweep_warp.DISPLACEMENT,
                sweep_warp.DISPLACEMENT_BACKWARD)
    real_step = FlowTrainer.train_step
    backward = sweep_warp.displacement_volume_backward_cuda
    rows, grads, timer = [], [], []

    def record_backward(dout, y, flow, md):
        grads.append(dout.clone())
        return backward(dout, y, flow, md)

    def timed_step(trainer, *args, **kw):
        warm = not timer
        if warm:
            timer.append(FlowStageTimer(trainer))
            sweep_warp.displacement_volume_backward_cuda = record_backward
        model = trainer.model
        state = {k: v.clone() for k, v in model.state_dict().items()}
        before = _launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer[0]._mark("step_start")
        recording = recording_displacement(sweep_warp) if warm else contextlib.nullcontext([])
        try:
            with recording as calls:
                metrics = real_step(trainer, *args, **kw)
        finally:
            sweep_warp.displacement_volume_backward_cuda = backward
        timer[0]._mark("step_end")
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n = tuple(a - b for a, b in zip(_launches(*counters), before))
        i = len(rows) + (0 if warm else 1)
        loss, epe = float(metrics["loss"]), float(metrics["epe"])
        check(math.isfinite(loss) and math.isfinite(epe), f"{what} step {i}: loss {loss}, "
              f"EPE {epe}")
        check(n == FLOW_PER_STEP, f"{what} step {i}: gather, sweep, sweep backward, pose "
              f"gradient, displacement volume, its backward launched {n} times, expected "
              f"{FLOW_PER_STEP}")
        got_grad = [k for k, p in model.named_parameters() if p.grad is not None and p.grad.any()]
        params = dict(model.named_parameters())
        still = [k for k in got_grad if torch.equal(params[k], state[k])]
        check(len(got_grad) > 200 and not still, f"{what} step {i}: {len(got_grad)} DICL "
              f"parameters got a gradient; unmoved: {still[:3]}")
        now = model.state_dict()
        stale = [k for k in now if k.endswith("running_mean") and torch.equal(now[k], state[k])]
        check(not stale, f"{what} step {i}: DICL BN statistics did not move: {stale[:3]}")
        if warm:
            check(len(calls) == len(grads) == DISP_PER_PAIR, f"{what}: recorded "
                  f"{len(calls)} volumes and {len(grads)} gradients")
            by_shape = {tuple(d.shape[-2:]): d for d in grads}
            captured.extend((by_shape[tuple(x.shape[-2:])], x, y, f, md) for x, y, f, md in calls)
            for k in counters:
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
            log(f"{what}: warm-up step {ms:.1f} ms, loss {loss:.4f}, EPE {epe:.4f}; "
                f"displacement-volume inputs {_disp_shapes(calls)}, gradients "
                f"{[tuple(d.shape) for d in grads]} {grads[0].dtype}")
        else:
            rows.append(dict(ms=ms, loss=loss, epe=epe, **timer[0].stages_ms()))
            r = rows[-1]
            log(f"{what}: step {i}: {ms:.1f} ms (feature net {r['feature']:.1f}, levels "
                f"{r['levels']:.1f}, loss + backward {r['loss_backward']:.1f}, optimizer "
                f"{r['optimizer']:.1f} ms device); loss {loss:.4f}, EPE {epe:.4f}; launches {n}")
            if len(rows) == FLOW_STEPS:
                rows.append(dict(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                 launches=_launches(*counters)))
        return metrics

    captured = []
    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti_flow"
        t0 = time.perf_counter()
        write_kitti_flow_tree(root, n_pairs=FLOW_PAIRS, hw=FLOW_HW, focal=K_KITTI[0][0])
        log(f"{what}: KITTI flow tree of {FLOW_PAIRS} {FLOW_HW[0]}x{FLOW_HW[1]} pairs rendered "
            f"in {time.perf_counter() - t0:.2f} s")
        argv = ["--data", root, "--cfg", "kitti", "--train-flow", "--flow-dataset", "kitti",
                "--flow-crop", str(FLOW_CROP[0]), str(FLOW_CROP[1]), "-b", str(TRAIN_B),
                "--epochs", "1", "--out", f"{tmp}/out", "--workers", "4"]
        log(f"{what}: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        for k in counters:
            k.launches = 0
        FlowTrainer.train_step = timed_step
        try:
            t0 = time.perf_counter()
            history = cli.main(argv)
            wall = time.perf_counter() - t0
        finally:
            FlowTrainer.train_step = real_step
        launches = _launches(*counters)
        ckpt = f"{tmp}/out/kitti_flow/ckpt"
        check(os.path.exists(f"{ckpt}/0.pt") and os.path.exists(f"{ckpt}/model_best.pt"),
              f"{what}: no checkpoint written")
        # the flow checkpoint restores into the composite
        model = SFMNet(SfMConfig.kitti(), device=dev, seed=5)
        psnet = {k: v.clone() for k, v in model.depth_estimator.state_dict().items()}
        cli.apply_pretrained(cli.build_parser().parse_args(
            ["--data", root, "--pretrained-flow", ckpt]), model)
        want = torch.load(f"{ckpt}/0.pt", map_location=dev, weights_only=True)["model"]
        got = model.flow_estimator.state_dict()
        check(set(got) == set(want) and all(torch.equal(got[k], v) for k, v in want.items()),
              f"{what}: --pretrained-flow did not restore every DICL tensor")
        check(all(torch.equal(v, psnet[k]) for k, v in model.depth_estimator.state_dict().items()),
              f"{what}: --pretrained-flow touched PSNet")
        del model, want, got, psnet
    check(len(rows) == FLOW_STEPS + 1, f"{what}: {len(rows) - 1} timed steps, expected "
          f"{FLOW_STEPS}")
    tail = rows.pop()
    check(tail["launches"] == tuple(FLOW_STEPS * n for n in FLOW_PER_STEP),
          f"{what}: the timed steps launched {tail['launches']}")
    rec = history[0] if len(history) == 1 else {}
    check(all(math.isfinite(rec.get(k, math.nan)) for k in ("train_loss", "epe", "f1_all"))
          and rec.get("n") == FLOW_PAIRS, f"{what}: epoch record {history}")
    mean = {k: sum(r[k] for r in rows) / FLOW_STEPS for k in rows[0]}
    log(f"{what}: mean over {FLOW_STEPS} steps at b = {TRAIN_B}, {FLOW_CROP[0]}x{FLOW_CROP[1]}: "
        f"{mean['ms']:.2f} ms/step ({1e3 * TRAIN_B / mean['ms']:.3f} pairs/s); device stages "
        f"feature net {mean['feature']:.2f}, levels {mean['levels']:.2f}, loss + backward "
        f"{mean['loss_backward']:.2f}, optimizer {mean['optimizer']:.2f} ms (step "
        f"{mean['step']:.2f}); peak memory {tail['peak_gib']:.2f} GiB; cli.main {wall:.2f} s; "
        f"validation over {rec['n']} pairs at {-(-FLOW_HW[0] // 128) * 128}x"
        f"{-(-FLOW_HW[1] // 128) * 128}: EPE {rec['epe']:.4f} px, Fl-all "
        f"{rec['f1_all']:.2f}%; train loss {rec['train_loss']:.4f}; --pretrained-flow restored "
        f"every DICL tensor into SFMNet, PSNet untouched; launches after the warm-up, "
        f"validation included: {launches}")
    log(f"{what} rows: " + json.dumps(rows))
    return launches, captured


PWC_TRAIN_STEPS = 2
# gather, sweep, sweep backward, sweep pose gradient, displacement volume,
# its backward, warped correlation, B2: the frozen PWC-DC step's flow is
# PWC-DC's five correlations (no gradient reaches it), its depth PSNet's
PWC_TRAIN_PER_STEP = (0, SWEEP_PER_PAIR, 1, 0, 0, 0, WARPED_PER_PAIR, 1)


def phase_cli_train_pwc(dev, sweep_warp, local_corr):
    """The frozen-flow depth-training step on the PWC-DC route through
    `cli.main` in training mode (`--override flow.estimator=PWC`; PWC-DC runs
    in train mode under no gradient, JAX's `flow_net(pair, train=True,
    all_iters=True)`), on slice 5's rendered tree: 370x1224 cropped to
    256x768, b = 4, nlabel 128, bf16, full width. One warm-up step, the
    launch counts reset, PWC_TRAIN_STEPS timed steps, the epoch's
    validation. Each step must give a finite loss, leave PWC-DC's
    parameters bit-identical, move PSNet's, and launch B2 once, the warped
    correlation four times, the sweep and its backward once and no other
    kernel. Reports ms per step by the host clock around a synchronised
    step and the peak memory of the timed steps. Returns the launches after
    the warm-up, validation included (gather, sweep, sweep backward, pose
    gradient, displacement volume, its backward, warped correlation, B2),
    and the warped correlation's inputs of the warm-up step (levels 5..2)."""
    from deep_sfm_revisited_tpu_torch import cli
    from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_raw_tree
    from deep_sfm_revisited_tpu_torch.train.trainer import Trainer

    what = "cli train (PWC-DC)"
    counters = (sweep_warp.KERNEL, sweep_warp.VOLUME, sweep_warp.VOLUME_BACKWARD,
                sweep_warp.VOLUME_POSE_GRAD, sweep_warp.DISPLACEMENT,
                sweep_warp.DISPLACEMENT_BACKWARD, local_corr.WARPED, local_corr.KERNEL)
    real_step, launch_w = Trainer.train_step, local_corr.warped_correlation_cuda
    steps, cap_w = [], []

    def record_w(f1, f2, flow, scale, md):
        cap_w.append((f1.clone(), f2.clone(), flow.clone(), scale, md))
        return launch_w(f1, f2, flow, scale, md)

    def timed_step(trainer, *args, **kw):
        model = trainer.model
        flow_net = {k: p.detach().clone() for k, p in model.flow_estimator.named_parameters()}
        psnet = {k: p.detach().clone() for k, p in model.depth_estimator.named_parameters()}
        before = _launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not steps:
            local_corr.warped_correlation_cuda = record_w
        try:
            metrics = real_step(trainer, *args, **kw)
        finally:
            local_corr.warped_correlation_cuda = launch_w
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n = tuple(a - b for a, b in zip(_launches(*counters), before))
        i = len(steps)
        loss = float(metrics["loss"])
        check(math.isfinite(loss), f"{what} step {i}: loss {loss}")
        check(n == PWC_TRAIN_PER_STEP, f"{what} step {i}: gather, sweep, sweep backward, pose "
              f"gradient, displacement volume, its backward, warped correlation, B2 launched "
              f"{n} times, expected {PWC_TRAIN_PER_STEP}")
        for k, p in model.flow_estimator.named_parameters():
            check(torch.equal(p, flow_net[k]) and p.grad is None,
                  f"{what} step {i}: PWC-DC parameter {k} moved or got a gradient")
        moved = [k for k, p in model.depth_estimator.named_parameters()
                 if not torch.equal(p, psnet[k])]
        check(moved, f"{what} step {i}: no PSNet parameter moved")
        if i == 0:
            for k in counters:
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
            log(f"{what}: warm-up step {ms:.1f} ms, loss {loss:.4f}; warped correlation inputs "
                f"{_warped_inputs_desc(cap_w)}")
        else:
            log(f"{what}: step {i}: {ms:.1f} ms, loss {loss:.4f}; launches {n}")
        steps.append(dict(ms=ms, loss=loss, peak_gib=torch.cuda.max_memory_allocated() / 2**30))
        return metrics

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti_raw"
        n_test = 2
        write_kitti_raw_tree(root, n_frames=n_test + TRAIN_B * (PWC_TRAIN_STEPS + 1),
                             hw=(370, 1224), focal=K_KITTI[0][0], n_test=n_test)
        argv = ["--data", root, "--cfg", "kitti", "--gt-depth-dir", f"{root}/gt_depth",
                "--out", f"{tmp}/out", "--workers", "4", "-b", str(TRAIN_B), "--epochs", "1",
                "--override", f"data.train_size={TRAIN_HW}", "flow.estimator=PWC",
                "data.pad_multiple=64", *[f"{k}={v}" for k, v in BENCH_OVERRIDES.items()]]
        log(f"{what}: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        for k in counters:
            k.launches = 0
        Trainer.train_step = timed_step
        try:
            history = cli.main(argv)
        finally:
            Trainer.train_step = real_step
        launches = _launches(*counters)
        check(os.path.exists(f"{tmp}/out/kitti/ckpt/0.pt"), f"{what}: no checkpoint written")
    check(len(steps) == PWC_TRAIN_STEPS + 1, f"{what}: {len(steps) - 1} timed steps, expected "
          f"{PWC_TRAIN_STEPS}")
    check(len(history) == 1 and all(math.isfinite(history[0][k]) for k in EIGEN_KEYS),
          f"{what}: validation {history}")
    timed = steps[1:]
    log(f"{what}: mean over {PWC_TRAIN_STEPS} steps at b = {TRAIN_B}, {TRAIN_HW[0]}x"
        f"{TRAIN_HW[1]}: {sum(r['ms'] for r in timed) / len(timed):.2f} ms/step "
        f"({json.dumps([round(r['ms'], 2) for r in timed])}); peak memory "
        f"{timed[-1]['peak_gib']:.2f} GiB; launches after the warm-up, validation included "
        f"(gather, sweep, sweep backward, pose gradient, displacement volume, its backward, "
        f"warped correlation, B2): {launches}")
    check(len(cap_w) == WARPED_PER_PAIR, f"{what}: {len(cap_w)} warped correlations recorded")
    return launches, cap_w


# ---------------------------------------------------------------- slice 13

# PWC-DC's flow pretraining: B2 and its backward once a step (level 6), the
# warped correlation and its backward four times (levels 5..2)
PWC_FLOW_HW = (384, 1280)   # KITTI 2015's 375x1242, rendered where PWC-DC takes /8-padded pairs
PWC_FLOW_PER_STEP = (1, 1, WARPED_PER_PAIR, WARPED_PER_PAIR)
PWC_FLOW_WARMUP, PWC_FLOW_STEPS = 3, 6   # phase 21's untimed and timed steps
PWC_FLOW_PAIRS = TRAIN_B * (PWC_FLOW_WARMUP + PWC_FLOW_STEPS)
CORR_BWD_SOURCE = f"{PKG}/csrc/warped_corr_backward.cu"
B2_BWD_REPLACES = "deep_sfm_revisited_tpu/ops/correlation.py:28"
WARPED_BWD_REPLACES = "deep_sfm_revisited_tpu/models/pwcnet.py:125"
# the warped backward's float32 work per (pixel, channel) of a valid sample:
# the halo's blend of w (B1's 10), the two divisions by C, d f2's four
# weighted taps (2 products each) and d flow's terms (4 differences, 4
# products, 2 sums, 2 products, 2 sums)
CORR_BWD_FLOPS_PER_TAP = B1_FLOPS_PER_OUTPUT + 2 + 8 + 14


def old_corr_backward(path: Path):
    """The backward kernels of an earlier `warped_corr_backward.cu` whose C
    entry points take no mapping (`..., int md, void* stream)` and
    `..., int md, int dtype, void* stream)`), built by
    `ops/cuda/build.py` beside the current sources and called through
    ctypes as that source's operators called them: d f1 and the float32 d f2
    buffer allocated, the buffer zeroed, the launch (and in bfloat16 the
    cast, inside it). Returns (b2, warped) with the current wrappers'
    arguments and results."""
    import ctypes

    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    text = path.read_text()
    check("int md, void* stream)" in text and "int md, int dtype, void* stream)" in text,
          f"{path} has no backward entry points without a mapping")
    P, I = ctypes.c_void_p, ctypes.c_int

    class OldBackward(CudaKernel):
        source = str(path.resolve())   # an absolute path replaces csrc/

        def _bind(self, lib):
            fn = lib.dsfm_local_correlation_backward
            fn.argtypes = [P] * 5 + [I] * 5 + [P]
            fn.restype = I
            fn = lib.dsfm_warped_correlation_backward
            fn.argtypes = ([P] * 3 + [I] * 5 + [ctypes.c_float, P, ctypes.c_longlong,
                                                ctypes.c_longlong] + [P] * 4 + [I] * 4
                           + [I] * 6 + [P])
            fn.restype = I

    lib = OldBackward().build()

    def b2(f0, f1, dout, md):
        B_, H_, W_, C_ = f0.shape
        d0, d1 = torch.empty_like(f0), torch.empty_like(f1)
        err = lib.dsfm_local_correlation_backward(
            f0.data_ptr(), f1.data_ptr(), dout.data_ptr(), d0.data_ptr(), d1.data_ptr(), B_, H_,
            W_, C_, md, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"{path}'s B2 backward launch failed: cudaError {err}")
        return d0, d1

    def warped(f1, f2, flow, scale, dout, md):
        B_, C_, H_, W_ = f1.shape
        cl = torch.channels_last
        df1 = torch.empty_like(f1, memory_format=cl)
        acc = torch.empty((B_, C_, H_, W_), device=f1.device, memory_format=cl)
        acc.zero_()
        df2 = acc if f1.dtype == torch.float32 else torch.empty_like(f1, memory_format=cl)
        dflow = torch.empty_like(flow)
        err = lib.dsfm_warped_correlation_backward(
            f1.data_ptr(), f2.data_ptr(), flow.data_ptr(), int(flow.dtype == torch.bfloat16),
            *flow.stride(), ctypes.c_float(scale), dout.data_ptr(), dout.stride(0),
            dout.stride(3), df1.data_ptr(), df2.data_ptr(), acc.data_ptr(), dflow.data_ptr(),
            *dflow.stride(), B_, H_, W_, C_, md, int(f1.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"{path}'s warped backward launch failed: cudaError {err}")
        return df1, df2, dflow

    return b2, warped


def _corr_counters(local_corr):
    return (local_corr.KERNEL, local_corr.KERNEL_BACKWARD, local_corr.WARPED,
            local_corr.WARPED_BACKWARD)


def phase_small_pwc_flow_train_reference(dev, local_corr) -> None:
    """One PWC-DC flow-pretraining step (`train/flow_trainer.py::FlowTrainer`,
    `flow.estimator=PWC`, float32, TF32 off) at 128x128, b = 2, on the card
    against the same step on the CPU (the plain versions, both correlations'
    plain backwards) from the same weights and batch: the loss and EPE to
    1e-4 relative; PWC-DC's clipped gradients, all tensors together, within
    twice the largest relative move (L2) the CPU's own gradients make under
    rounding-sized changes of the input (the reference image scaled by 1 +-
    1e-6 and 1 + 3e-6, and plus +-1e-7, +-3e-7 times a fixed noise image),
    and 1 - cosine <= 1e-4; the per-tensor moves against twice the CPU's are
    logged (a leaky ReLU unit within rounding of zero changes its slope
    between devices). The card's step must launch B2 and its backward once
    each and the warped correlation and its backward four times each."""
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.train.flow_trainer import FlowTrainer, build_flow_model

    what = "small PWC-DC flow-train reference"
    cfg = SfMConfig.kitti().override(**{"train.mixed_prec": False, "flow.estimator": "PWC"})
    h = w = 128
    g = torch.Generator().manual_seed(13)
    ref = torch.rand((2, h, w, 3), generator=g) * 2 - 1
    batch = {"ref": ref,
             "target": torch.roll(ref, (2, 3), dims=(1, 2))
             + 0.05 * torch.randn((2, h, w, 3), generator=g),
             "flow_gt": torch.tensor([3.0, 2.0]) + torch.randn((2, h, w, 2), generator=g),
             "flow_valid": torch.rand((2, h, w), generator=g) < 0.7}
    noise = torch.randn((2, h, w, 3), generator=g)

    def step(device, scale=1.0, eps=0.0):
        t = FlowTrainer(build_flow_model(cfg.flow, seed=3).to(device), cfg, total_steps=40)
        b = {k: v.to(device) for k, v in
             dict(batch, ref=batch["ref"] * scale + eps * noise).items()}
        m = t.train_step(b)
        return ({k: float(v) for k, v in m.items()},
                {k: p.grad.detach().cpu() for k, p in t.model.named_parameters()})

    def l2(got, want):
        a = torch.cat([got[k].double().flatten() for k in want])
        b = torch.cat([want[k].double().flatten() for k in want])
        return float((a - b).norm() / b.norm())

    counters = _corr_counters(local_corr)
    before = _launches(*counters)
    m_card, g_card = step(dev)
    torch.cuda.synchronize()
    n = tuple(a - b for a, b in zip(_launches(*counters), before))
    check(n == PWC_FLOW_PER_STEP, f"{what}: B2, its backward, the warped correlation and its "
          f"backward launched {n} times, expected {PWC_FLOW_PER_STEP}")
    m_cpu, g_cpu = step("cpu")
    self_errs, self_l2, self_cos = {}, 0.0, 0.0
    for kw in (dict(scale=1 + 1e-6), dict(scale=1 - 1e-6), dict(scale=1 + 3e-6),
               dict(eps=1e-7), dict(eps=-1e-7), dict(eps=3e-7), dict(eps=-3e-7)):
        moved = step("cpu", **kw)[1]
        e, c = _grad_report(moved, g_cpu)
        self_errs = {k: max(v, self_errs.get(k, 0.0)) for k, v in e.items()}
        self_l2, self_cos = max(self_l2, l2(moved, g_cpu)), max(self_cos, c)
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in ("loss", "epe")}
    errs, cos_err = _grad_report(g_card, g_cpu)
    l2_err = l2(g_card, g_cpu)
    over = [k for k in errs if errs[k] > max(1e-3, 2 * self_errs[k])]
    worst = max(errs, key=errs.get)
    log(f"{what}: loss card {m_card['loss']:.7f} vs cpu {m_cpu['loss']:.7f} (relative "
        f"{rel['loss']:.2e}), EPE {m_card['epe']:.6f} vs {m_cpu['epe']:.6f} (relative "
        f"{rel['epe']:.2e}); PWC-DC gradients: relative L2 {l2_err:.2e} against the CPU's own "
        f"{self_l2:.2e} at seven perturbed inputs, 1 - cosine {cos_err:.2e} (the CPU's own "
        f"{self_cos:.2e}); per tensor worst {errs[worst]:.2e} ({worst}), "
        f"{sum(e <= 1e-3 for e in errs.values())}/{len(errs)} within 1e-3 of their max, beyond "
        f"twice the CPU's own move: {len(over)} "
        f"({', '.join(f'{k} {errs[k]:.2e}' for k in over[:3])}); launches (B2, its backward, "
        f"warped, its backward) {n}")
    check(all(math.isfinite(v) for v in m_card.values()), f"{what}: metrics {m_card}")
    check(max(rel.values()) <= 1e-4, f"{what}: loss or EPE differs: {rel}")
    check(all(g.abs().max() > 0 for g in g_card.values()), f"{what}: a PWC-DC parameter got no "
          "gradient on the card")
    check(l2_err <= 2 * self_l2, f"{what}: the gradients differ by {l2_err} (relative L2), "
          f"beyond twice the CPU's own {self_l2}")
    check(cos_err <= 1e-4, f"{what}: 1 - cosine of the gradients {cos_err}")


def phase_cli_train_flow_pwc(dev, sweep_warp, local_corr):
    """Slice 13 through `cli.main --train-flow --override flow.estimator=PWC`
    on a KITTI 2015 flow tree rendered at 384x1280 (PWC-DC takes /64 sides
    and the CLI pads its batches and validation pairs to /8, as JAX does;
    KITTI's 375x1242 would reach it at 376x1248), PWC_FLOW_PAIRS pairs,
    cropped to 256x768, b = 4, one epoch, PWC-DC at full width, bf16:
    PWC_FLOW_WARMUP untimed steps, the first of which records both backward
    kernels' inputs and gradients, then PWC_FLOW_STEPS timed steps with the
    launch counts reset after the warm-up; every step must launch B2 and
    its backward once, the warped correlation and its backward four times
    and no B1 kernel, give a finite loss and EPE and move every PWC-DC
    parameter; ms/step by the host clock around a synchronised step (mean,
    median and the spread of the timed steps, each step logged, the
    warm-up's too), the stage split and peak memory; then the
    epoch's validation (EPE and Fl-all, finite) and checkpoint, which
    `--pretrained-flow` restores into an SFMNet built with
    `flow.estimator=PWC` with every PWC-DC tensor equal and PSNet untouched.
    Returns (launches over the timed steps and the validation: B1's six
    kernels, then B2, its backward, the warped correlation, its backward;
    the warm-up's backward calls [(kind, args)])."""
    from deep_sfm_revisited_tpu_torch import cli
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_flow_tree
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
    from deep_sfm_revisited_tpu_torch.train.flow_trainer import FlowTrainer

    what = "cli train-flow (PWC-DC)"
    b1 = (sweep_warp.KERNEL, sweep_warp.VOLUME, sweep_warp.VOLUME_BACKWARD,
          sweep_warp.VOLUME_POSE_GRAD, sweep_warp.DISPLACEMENT, sweep_warp.DISPLACEMENT_BACKWARD)
    counters = b1 + _corr_counters(local_corr)
    per_step = (0,) * len(b1) + PWC_FLOW_PER_STEP
    real_step = FlowTrainer.train_step
    real = (local_corr.local_correlation_backward_cuda, local_corr.warped_correlation_backward_cuda)
    rows, timer, captured, strides, calls = [], [], [], [], []

    def record_b2(f0, f1, dout, md):
        captured.append(("b2", (f0.clone(), f1.clone(), dout.clone(), md)))
        return real[0](f0, f1, dout, md)

    def record_warped(f1, f2, flow, scale, dout, md):
        strides.append(dout.stride())   # the decoder input's gradient, sliced
        captured.append(("warped", (f1.clone(), f2.clone(), flow.clone(), scale, dout.clone(),
                                    md)))
        return real[1](f1, f2, flow, scale, dout, md)

    def timed_step(trainer, *args, **kw):
        calls.append(len(calls) + 1)
        first, warm = len(calls) == 1, len(calls) <= PWC_FLOW_WARMUP
        if first:
            timer.append(FlowStageTimer(trainer))
            local_corr.local_correlation_backward_cuda = record_b2
            local_corr.warped_correlation_backward_cuda = record_warped
        model = trainer.model
        state = {k: p.detach().clone() for k, p in model.named_parameters()}
        before = _launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer[0]._mark("step_start")
        try:
            metrics = real_step(trainer, *args, **kw)
        finally:
            local_corr.local_correlation_backward_cuda, \
                local_corr.warped_correlation_backward_cuda = real
        timer[0]._mark("step_end")
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n = tuple(a - b for a, b in zip(_launches(*counters), before))
        i = f"warm-up {calls[-1]}" if warm else f"{len(rows) + 1}"
        loss, epe = float(metrics["loss"]), float(metrics["epe"])
        check(math.isfinite(loss) and math.isfinite(epe), f"{what} step {i}: loss {loss}, "
              f"EPE {epe}")
        check(n == per_step, f"{what} step {i}: B1's six kernels, B2, its backward, the warped "
              f"correlation, its backward launched {n} times, expected {per_step}")
        still = [k for k, p in model.named_parameters() if torch.equal(p, state[k])]
        check(not still, f"{what} step {i}: PWC-DC parameters did not move: {still[:3]}")
        if warm:
            if first:
                kinds = [c[0] for c in captured]
                check(kinds.count("b2") == 1 and kinds.count("warped") == WARPED_PER_PAIR,
                      f"{what}: recorded backward calls {kinds}")
                log(f"{what}: backward inputs " + ", ".join(
                    f"{kind} {tuple(a[0].shape)} {a[0].dtype} dout {tuple(a[-2].shape)}"
                    for kind, a in captured)
                    + f"; the warped levels' dout strides as autograd gave them {strides}")
            log(f"{what}: step {i}: {ms:.1f} ms, loss {loss:.4f}, EPE {epe:.4f} (untimed)")
            if calls[-1] == PWC_FLOW_WARMUP:
                for k in counters:
                    k.launches = 0
                torch.cuda.reset_peak_memory_stats()
        else:
            rows.append(dict(ms=ms, loss=loss, epe=epe, **timer[0].stages_ms()))
            r = rows[-1]
            log(f"{what}: step {i}: {ms:.1f} ms (forward {r['forward']:.1f}, loss + backward "
                f"{r['loss_backward']:.1f}, optimizer {r['optimizer']:.1f} ms device); loss "
                f"{loss:.4f}, EPE {epe:.4f}; launches {n}")
            if len(rows) == PWC_FLOW_STEPS:
                rows.append(dict(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                 launches=_launches(*counters)))
        return metrics

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti_flow"
        t0 = time.perf_counter()
        write_kitti_flow_tree(root, n_pairs=PWC_FLOW_PAIRS, hw=PWC_FLOW_HW, focal=K_KITTI[0][0])
        log(f"{what}: KITTI flow tree of {PWC_FLOW_PAIRS} {PWC_FLOW_HW[0]}x{PWC_FLOW_HW[1]} pairs "
            f"rendered in {time.perf_counter() - t0:.2f} s")
        argv = ["--data", root, "--cfg", "kitti", "--train-flow", "--flow-dataset", "kitti",
                "--flow-crop", str(FLOW_CROP[0]), str(FLOW_CROP[1]), "-b", str(TRAIN_B),
                "--epochs", "1", "--out", f"{tmp}/out", "--workers", "4",
                "--override", "flow.estimator=PWC"]
        log(f"{what}: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        for k in counters:
            k.launches = 0
        FlowTrainer.train_step = timed_step
        try:
            t0 = time.perf_counter()
            history = cli.main(argv)
            wall = time.perf_counter() - t0
        finally:
            FlowTrainer.train_step = real_step
        launches = _launches(*counters)
        ckpt = f"{tmp}/out/kitti_flow/ckpt"
        check(os.path.exists(f"{ckpt}/0.pt") and os.path.exists(f"{ckpt}/model_best.pt"),
              f"{what}: no checkpoint written")
        cfg = SfMConfig.kitti().override(**{"flow.estimator": "PWC"})
        model = SFMNet(cfg, device=dev, seed=5)
        psnet = {k: v.clone() for k, v in model.depth_estimator.state_dict().items()}
        cli.apply_pretrained(cli.build_parser().parse_args(
            ["--data", root, "--pretrained-flow", ckpt]), model)
        want = torch.load(f"{ckpt}/0.pt", map_location=dev, weights_only=True)["model"]
        got = model.flow_estimator.state_dict()
        check(len(want) == 126 and set(got) == set(want)
              and all(torch.equal(got[k], v) for k, v in want.items()),
              f"{what}: --pretrained-flow did not restore every PWC-DC tensor")
        check(all(torch.equal(v, psnet[k]) for k, v in model.depth_estimator.state_dict().items()),
              f"{what}: --pretrained-flow touched PSNet")
        del model, want, got, psnet
    check(len(rows) == PWC_FLOW_STEPS + 1, f"{what}: {len(rows) - 1} timed steps, expected "
          f"{PWC_FLOW_STEPS}")
    tail = rows.pop()
    check(tail["launches"] == tuple(PWC_FLOW_STEPS * n for n in per_step),
          f"{what}: the timed steps launched {tail['launches']}")
    rec = history[0] if len(history) == 1 else {}
    check(all(math.isfinite(rec.get(k, math.nan)) for k in ("train_loss", "epe", "f1_all"))
          and rec.get("n") == PWC_FLOW_PAIRS, f"{what}: epoch record {history}")
    mean = {k: sum(r[k] for r in rows) / PWC_FLOW_STEPS for k in rows[0]}
    ms = sorted(r["ms"] for r in rows)
    median = (ms[(len(ms) - 1) // 2] + ms[len(ms) // 2]) / 2
    log(f"{what}: the timed steps' host ms: median {median:.2f}, min {ms[0]:.2f}, max "
        f"{ms[-1]:.2f}, spread (max - min) / median {(ms[-1] - ms[0]) / median:.3f}")
    log(f"{what}: mean over {PWC_FLOW_STEPS} steps at b = {TRAIN_B}, {FLOW_CROP[0]}x"
        f"{FLOW_CROP[1]}: {mean['ms']:.2f} ms/step ({1e3 * TRAIN_B / mean['ms']:.3f} pairs/s); "
        f"device stages "
        f"forward {mean['forward']:.2f}, loss + backward {mean['loss_backward']:.2f}, "
        f"optimizer {mean['optimizer']:.2f} ms (step {mean['step']:.2f}); peak memory "
        f"{tail['peak_gib']:.2f} GiB; cli.main {wall:.2f} s; validation over {rec['n']} pairs "
        f"at {PWC_FLOW_HW[0]}x{PWC_FLOW_HW[1]}: EPE {rec['epe']:.4f} px, Fl-all "
        f"{rec['f1_all']:.2f}%; train loss {rec['train_loss']:.4f}; --pretrained-flow restored "
        f"every PWC-DC tensor into SFMNet, PSNet untouched; launches after the warm-up, "
        f"validation included: {launches}")
    log(f"{what} rows: " + json.dumps(rows))
    return launches, captured


def _edge_exact(flow, scale):
    """A copy of the flow whose border pixels' samples land exactly on the
    frame's edges (a zero flow) and whose every third column's land on
    integer positions (5-pixel steps, which every PWC-DC scale multiplies
    exactly)."""
    out = flow.clone()
    out[..., [0, -1], :] = 0
    out[..., :, [0, -1]] = 0
    h, w = flow.shape[-2:]
    steps = torch.tensor([-1.0, 0.0, 1.0], device=flow.device)[
        torch.arange(h * w, device=flow.device) % 3].reshape(h, w) * (5.0 / scale)
    out[:, :, 1:-1, 2:-1:3] = steps[1:-1, 2:-1:3].to(flow.dtype)
    return out


def _in_frame_pairs(h, w, md):
    """(pixel, displacement) pairs of one image whose p + d lies in the
    frame: the dout elements a backward needs, and its products."""
    r, c = torch.arange(h), torch.arange(w)
    ny = sum(((r + d >= 0) & (r + d < h)).long() for d in range(-md, md + 1))
    nx = sum(((c + d >= 0) & (c + d < w)).long() for d in range(-md, md + 1))
    return int(ny.sum()) * int(nx.sum())


def _valid_samples(flow, scale):
    B_, _, h, w = flow.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=flow.device, dtype=torch.float32),
                            torch.arange(w, device=flow.device, dtype=torch.float32),
                            indexing="ij")
    x = gx + flow[:, 0].float() * scale
    y = gy + flow[:, 1].float() * scale
    return int(((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)).sum())


def _corr_bwd_bound(kind, args):
    """(bytes, flops, operations ms) of one backward call: every input read
    once at its own size (dout only where p + d lies in the frame), every
    gradient written once; the two sums' products and adds of the in-frame
    (pixel, displacement) pairs times C at the tensor cores' bfloat16 rate
    where the features are bfloat16 and at the float32 rate otherwise, and
    the warp's float32 work per (valid sample, channel)
    (CORR_BWD_FLOPS_PER_TAP)."""
    f1, dout = args[0], args[-2]
    if kind == "b2":
        B_, h, w, c = f1.shape
        ins = (args[0], args[1])
    else:
        B_, c, h, w = f1.shape
        ins = (args[0], args[1], args[2])
    pairs = B_ * _in_frame_pairs(h, w, args[-1])
    nbytes = (pairs * dout.element_size() + 2 * sum(t.numel() * t.element_size() for t in ins))
    sums = 4 * pairs * c
    scalar = 2 * c * B_ * h * w
    if kind == "warped":
        scalar += CORR_BWD_FLOPS_PER_TAP * c * _valid_samples(args[2], args[3])
    rate = BF16_FLOPS if f1.dtype == torch.bfloat16 else F32_FLOPS
    return nbytes, sums + scalar, (sums / rate + scalar / F32_FLOPS) * 1e3


def _grad_tol(got, ref):
    """Per element: 1e-5 of the gradient's largest element (float32 sums in
    another order, d f2's atomics), plus, where the gradient is bf16, one
    bf16 ulp of the larger of the two elements (both sides round their
    float32 sums once). No absolute floor: phase 21's gradients are ~1e-6."""
    tol = 1e-5 * float(ref.float().abs().max())
    if ref.dtype != torch.bfloat16:
        return tol
    return tol + _bf16_ulp(torch.maximum(got.float().abs(), ref.float().abs()))


def phase_corr_backward(captured, local_corr, correlation, old_source=None):
    """The two backward kernels against their plain versions on the inputs
    and gradients phase 21's warm-up step gave them (B2's at level 6, the
    warped correlation's at levels 5..2), level by level: B2's in float32
    (it takes float32), the warped one in bf16 and float32, each on the
    captured gradient and flow, on a unit-scale random gradient (the
    captured ones are ~1e-6, so a wrong kernel fails there by many times
    the limit), on a flow that sends bands of samples off the frame and on
    one that puts samples exactly on the frame's edges and on integer
    positions. Tolerances (`_grad_tol`): float32 sums of up to 81 products
    and d f2's atomics in another order, 1e-5 of each gradient's largest
    element, plus one bf16 ulp of each element of a bf16 gradient; each
    case logs each gradient's max |plain| and the share of its tolerance
    used. B2's gradients and the warped d f1 and d flow bit-identical
    across two launches (gathers, and a fixed order over the channels), d
    f2 within the tolerance. Then per level, as the main path ran it:
    device time (torch.profiler: the kernel, d f2's zero fill and, in bf16,
    its cast; and by CUDA-graph replay, which traces cannot refuse), events
    time, the bound and its share, the plain version's time, and the
    yardsticks the port never calls: autograd of the eager composition
    (the plain forward, its backward alone: events, and device time by
    CUDA-graph replay of forward and backward less the forward's) and, for
    the warp's half, `grid_sampler_2d_backward` (input and grid gradients)
    of f2 at the level's samples. Each level's row also names its mapping
    (`local_corr.backward_plan`) with the kernel's registers, shared memory
    and resident blocks, and its bound's bytes and share. With `old_source`
    (an earlier `warped_corr_backward.cu` without mapping arguments, PR
    13's) that source's kernels run on the same inputs, are held to the
    plain versions' tolerance, and are timed in turns with the current
    ones, old, new, new, old, by CUDA-graph replay and on the device.
    Returns ({"b2": row, "warped": row}, {"b2": max |kernel - plain|,
    "warped": ...})."""
    max_err = {"b2": 0.0, "warped": 0.0}
    used = {}   # (kind, gradient) -> the largest share of its tolerance a case used
    cases = 0
    g = torch.Generator(device=captured[0][1][0].device).manual_seed(22)
    for kind, args in captured:
        variants = {"captured": args}
        unit = torch.randn(args[-2].shape, device=args[-2].device, generator=g)
        if kind == "warped":
            f1, f2, flow, scale, dout, md = args
            unit = unit.to(dout.dtype).contiguous(memory_format=torch.channels_last)
            variants["unit dout"] = (f1, f2, flow, scale, unit, md)
            variants["off the frame"] = (f1, f2, _off_frame(flow, scale), scale, dout, md)
            variants["edges"] = (f1, f2, _edge_exact(flow, scale), scale, dout, md)
        else:
            variants["unit dout"] = (*args[:2], unit, args[3])
        for vname, a in variants.items():
            for dtype in ((torch.float32,) if kind == "b2" else (torch.bfloat16, torch.float32)):
                if kind == "b2":
                    f0, f1, dout, md = a
                    got = local_corr.local_correlation_backward_cuda(f0, f1, dout, md)
                    again = local_corr.local_correlation_backward_cuda(f0, f1, dout, md)
                    ref = correlation.local_correlation_backward_plain(f0, f1, dout, md)
                    names, exact = ("d f0", "d f1"), (True, True)
                else:
                    f1, f2, flow, scale, dout, md = a
                    x = (f1.to(dtype), f2.to(dtype), flow.to(dtype), scale,
                         dout.to(dtype), md)
                    got = local_corr.warped_correlation_backward_cuda(*x)
                    again = local_corr.warped_correlation_backward_cuda(*x)
                    ref = correlation.warped_correlation_nchw_backward_plain(*x)
                    names, exact = ("d f1", "d f2", "d flow"), (True, False, True)
                tag = f"{kind} backward {tuple(a[0].shape)} {vname} {str(dtype)[6:]}"
                parts = []
                for nm, g_, g2, r, ex in zip(names, got, again, ref, exact):
                    check(g_.dtype == r.dtype and g_.shape == r.shape, f"{tag} {nm}: "
                          f"{g_.dtype} {tuple(g_.shape)}")
                    err = (g_.float() - r.float()).abs()
                    tol = _grad_tol(g_, r)
                    top = float(r.float().abs().max())
                    check(top > 0, f"{tag} {nm}: the plain gradient is zero")
                    share = float((err / tol).max())
                    used[kind, nm] = max(used.get((kind, nm), 0.0), share)
                    max_err[kind] = max(max_err[kind], float(err.max()))
                    parts.append(f"{nm} max |plain| {top:.3e}, max |kernel - plain| "
                                 f"{float(err.max()):.3e} ({share:.3f} of its tolerance)")
                    check(share <= 1.0, f"{tag} {nm}: max |kernel - plain| {float(err.max())} "
                          f"beyond tolerance (max |plain| {top})")
                    if ex:
                        check(torch.equal(g_, g2), f"{tag} {nm}: two launches differ")
                    else:
                        check(bool(((g_.float() - g2.float()).abs() <= _grad_tol(g2, r)).all()),
                              f"{tag} {nm}: two launches differ beyond the tolerance")
                log(f"{tag}: " + "; ".join(parts))
                cases += 1
                del got, again, ref
    log(f"correlation backwards: {cases} cases within their plain versions' tolerance; B2's "
        f"gradients and the warped d f1 and d flow bit-identical across launches; largest "
        f"|kernel - plain| B2's {max_err['b2']:.3e}, the warped one's {max_err['warped']:.3e}; "
        "the largest share of its tolerance a case used: "
        + ", ".join(f"{k} {nm} {v:.3f}" for (k, nm), v in used.items()))

    old = old_corr_backward(Path(old_source)) if old_source else None
    rows = {"b2": [], "warped": []}
    for kind, args in captured:
        if kind == "b2":
            f0, f1, dout, md = args
            B_, h_, w_, c_ = f0.shape
            p = local_corr.backward_plan(B_, c_, h_, w_, md, torch.float32, False)

            def run():
                local_corr.local_correlation_backward_cuda(f0, f1, dout, md)

            def plain():
                correlation.local_correlation_backward_plain(f0, f1, dout, md)

            leaves = (f0.clone().requires_grad_(), f1.clone().requires_grad_())

            def forward(*ins):
                return correlation.local_correlation_plain(*ins, md)

            ops, name = 1, "corr_backward_kernel"
        else:
            f1, f2, flow, scale, dout, md = args
            B_, c_, h_, w_ = f1.shape
            p = local_corr.backward_plan(B_, c_, h_, w_, md, f1.dtype, True)

            def run():
                local_corr.warped_correlation_backward_cuda(f1, f2, flow, scale, dout, md)

            def plain():
                correlation.warped_correlation_nchw_backward_plain(f1, f2, flow, scale, dout, md)

            leaves = [t.detach().clone().requires_grad_() for t in (f1, f2, flow)]

            def forward(*ins):
                return correlation.warped_correlation_nchw_plain(*ins, scale, md)

            ops, name = 2 + (f1.dtype == torch.bfloat16), "corr_backward_kernel"
        ms = cuda_ms(run, reps=20)
        kernel_graph = graph_ms(run)
        profile = _full_profile(run, ops)
        dev_ms, dev_ops = _profile_sums(profile)
        kern_ms = (None if profile is None
                   else sum(v[0] for n, v in profile.items() if name in n))
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        with torch.enable_grad():
            out = forward(*leaves)

        def eager():
            torch.autograd.grad(out, leaves, dout, retain_graph=True)

        # For the CUDA graph: forward and backward, from views of the leaves
        # made in the call, so that every node autograd runs (the leaves'
        # AccumulateGrad, made on the default stream above, is not among
        # them) belongs to the capture stream
        def eager_forward():
            with torch.enable_grad():
                ins = [t.view_as(t) for t in leaves]
                return forward(*ins), ins

        def eager_whole():
            y, ins = eager_forward()
            torch.autograd.grad(y, ins, dout)

        eager_ms = cuda_ms(eager, reps=3, warmup=1)
        try:
            # three calls on a side stream first, as PyTorch's whole-network
            # capture recipe does
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    eager_whole()
            torch.cuda.current_stream().wait_stream(side)
            eager_dev = graph_ms(eager_whole, reps=3) - graph_ms(eager_forward, reps=3)
        except RuntimeError as e:   # a yardstick the port never calls: logged, not measured
            log(f"{kind} backward: the eager composition's CUDA graph failed: {e}")
            eager_dev = None
        grid_ms = grid_dev = None
        if kind == "warped":
            B_, c, h, w = f2.shape
            co = torch.stack(torch.meshgrid(torch.arange(h, device=f2.device),
                                            torch.arange(w, device=f2.device),
                                            indexing="ij")[::-1])[None].float() + flow.float() * scale
            grid = torch.stack([co[:, 0] / (w - 1) * 2 - 1, co[:, 1] / (h - 1) * 2 - 1],
                               dim=-1).to(f2.dtype)
            gout = torch.ones_like(f2)

            def sampler():
                torch.ops.aten.grid_sampler_2d_backward(gout, f2, grid, 0, 0, True,
                                                        [True, True])

            grid_ms = cuda_ms(sampler, reps=20)
            grid_dev = _profile_sums(_full_profile(sampler))[0]
        nbytes, flops, ops_ms = _corr_bwd_bound(kind, args)
        bound, bound_by = _bound_ms(nbytes, ops_ms)
        shape = tuple(args[0].shape)
        res = local_corr.BACKWARD.resources(p, c_, md, args[0].dtype, kind == "warped")
        turns = {}
        if old is not None:
            old_fn = old[0] if kind == "b2" else old[1]
            got_old = old_fn(*args)
            plain_fn = (correlation.local_correlation_backward_plain if kind == "b2"
                        else correlation.warped_correlation_nchw_backward_plain)
            for nm, g_, r in zip(("d f1", "d f2", "d flow"), got_old, plain_fn(*args)):
                err = float((g_.float() - r.float()).abs().max())
                check(bool(((g_.float() - r.float()).abs() <= _grad_tol(g_, r)).all()),
                      f"{kind} backward {shape}: the earlier source's {nm} beyond tolerance "
                      f"({err})")
            del got_old
            turns = {"old_graph_ms": [], "new_graph_ms": [], "old_device_ms": [],
                     "new_device_ms": []}
            for who in ("old", "new", "new", "old"):
                fn = (lambda: old_fn(*args)) if who == "old" else run
                turns[f"{who}_graph_ms"].append(graph_ms(fn))
                turns[f"{who}_device_ms"].append(_profile_sums(_full_profile(fn, ops))[0])
        rows[kind].append(dict(
            name=f"{kind}_{shape}", shape=list(shape), dtype=str(args[0].dtype)[6:], md=md,
            dout_strides=list(dout.stride()), mapping=p.key, groups=p.groups, cluster=p.cluster,
            grid=list(p.grid), **res, ms=ms, device_ms=dev_ms, kernel_device_ms=kern_ms,
            graph_ms=kernel_graph, device_ops_per_call=dev_ops, plain_ms=plain_ms, library_ms=None,
            eager_autograd_ms=eager_ms, eager_autograd_device_ms=eager_dev,
            grid_sampler_backward_ms=grid_ms, grid_sampler_backward_device_ms=grid_dev,
            bound_ms=bound, bound_by=bound_by, ops_ms=ops_ms,
            bound_share=None if dev_ms is None else bound / dev_ms,
            bound_share_graph=bound / kernel_graph, bytes=nbytes, flops=flops, **turns))
        r = rows[kind][-1]
        share = "not measured" if dev_ms is None else f"{100 * bound / dev_ms:.1f}%"
        if turns:
            log(f"{kind} backward {shape} {r['dtype']} in turns (old, new, new, old): by CUDA "
                f"graph old {turns['old_graph_ms']} new {turns['new_graph_ms']} ms; device old "
                f"{turns['old_device_ms']} new {turns['new_device_ms']} ms")
        log(f"{kind} backward {shape} {r['dtype']}: mapping {p.key} ({p.groups} groups, grid "
            f"{p.grid}, {res['threads']} threads, {res['registers']} registers, "
            f"{res['smem_bytes']} B shared, {res['blocks_per_sm']} blocks an SM); bound "
            f"{nbytes / 1e6:.2f} MB, share {share} on the device, "
            f"{100 * bound / kernel_graph:.1f}% by CUDA graph")
        log(f"{kind} backward {shape} {r['dtype']}: device {_fmt_ms(dev_ms)} in {dev_ops} "
            f"device operations (the kernel {_fmt_ms(kern_ms)}), by CUDA graph "
            f"{kernel_graph:.4f} ms, events {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound:.5f} ms ({bound_by}, {nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP), share "
            f"{share}; yardsticks: eager autograd events {eager_ms:.4f} ms, device (CUDA graph, "
            f"the forward's taken off) {_fmt_ms(eager_dev)}; grid_sampler_2d_backward "
            f"{_fmt_ms(grid_ms)} events, device {_fmt_ms(grid_dev)}")
        del out, leaves
    out = {}
    for kind, calls in rows.items():
        total = _pair_sums(calls)
        for key in ("eager_autograd_ms", "eager_autograd_device_ms", "kernel_device_ms", "graph_ms",
                    "grid_sampler_backward_ms", "grid_sampler_backward_device_ms",
                    "device_ops_per_call"):
            total[key] = _sum_or_none(c[key] for c in calls)
        for key in ("old_graph_ms", "new_graph_ms", "old_device_ms", "new_device_ms"):
            if key in calls[0]:   # per turn, summed over the levels
                total[key] = [_sum_or_none(c[key][i] for c in calls) for i in range(2)]
        if "old_graph_ms" in total:
            log(f"{kind} backward per PWC-DC flow step in turns: by CUDA graph old "
                f"{total['old_graph_ms']} new {total['new_graph_ms']} ms; device old "
                f"{total['old_device_ms']} new {total['new_device_ms']} ms")
        total["bound_share"] = (None if total["device_ms"] is None
                                else total["bound_ms"] / total["device_ms"])
        out[kind] = dict(total, calls=calls)
        share = ("not measured" if total["bound_share"] is None
                 else f"{100 * total['bound_share']:.1f}%")
        log(f"{kind} backward per PWC-DC flow step: device {_fmt_ms(total['device_ms'])}, share "
            f"of bound {share}, by CUDA graph {total['graph_ms']:.4f} ms, events "
            f"{total['ms']:.4f} ms, bound {total['bound_ms']:.5f} ms "
            f"({total['bound_by']}), plain {total['plain_ms']:.4f} ms; eager autograd device "
            f"{_fmt_ms(total['eager_autograd_device_ms'])}; grid_sampler_2d_backward device "
            f"{_fmt_ms(total['grid_sampler_backward_device_ms'])}")
    return out, max_err


def _whole(profile: dict, reps: int) -> bool:
    """Every operation of the trace came `reps` times over (a whole number a
    call): a trace that lost or gained events shows a fraction. A trace
    that is not is logged, operation by operation."""
    if all(round(v[1] * reps) % reps == 0 for v in profile.values()):
        return True
    log(f"trace refused, events of {reps} calls: "
        + ", ".join(f"{n[:48]} {round(v[1] * reps)}" for n, v in profile.items()))
    return False


def _full_profile(fn, ops: int | None = None, reps: int = 20, tries: int = 10,
                  name: str | None = None) -> dict | None:
    """`device_profile` of `fn` (its kernels whose names contain `name`,
    where given) from a trace that holds every device operation of its
    calls. A trace now and then lacks events, some calls' or every one of
    a kernel, so of up to `tries` traces, each with every operation a whole
    number of times a call: with `ops`, the first that shows at least
    `ops` operations a call; with `ops` None, the first whose operations
    and counts an earlier one shows too. None when no trace qualifies: its
    times are then not measured, never summed from a partial trace."""
    seen = []
    for _ in range(tries):
        profile = device_profile(fn, reps)
        if name is not None:
            profile = {n: v for n, v in profile.items() if name in n}
        if not profile or not _whole(profile, reps):
            continue
        counts = {n: round(v[1] * reps) for n, v in profile.items()}
        if ops is not None:
            n = round(sum(v[1] for v in profile.values()))
            if n >= ops:
                return profile
            log(f"trace refused: {n} operations a call, {ops} expected")
        elif counts in seen:
            return profile
        seen.append(counts)
    return None


def _profile_sums(profile: dict | None) -> tuple:
    """(device ms, device operations) a call of a `_full_profile`; (None,
    None) where it was not measured."""
    if profile is None:
        return None, None
    return sum(v[0] for v in profile.values()), round(sum(v[1] for v in profile.values()))


def _disp_bwd_need(y, flow, md, dicl):
    """(dout elements the backward must read, (b, c, pixel) elements that
    scatter, (b, pixel) hole flags) at these inputs: an x-half element
    (s, c, p) where q = p + d_s is in the frame and hole(q), a y-half one
    where p = q - d_s is and hole(q) -- the same count; the scatter where
    hole(q) and the sample is valid."""
    B_, C_, h, w = y.shape
    yw = y if flow is None else dicl.warp_flow(y, flow, dicl.bilinear_sample_plain)
    hole = (yw != 0).any(dim=1)
    r = torch.arange(h, device=y.device)
    c = torch.arange(w, device=y.device)
    ny = sum(((r - dv >= 0) & (r - dv < h)).long() for dv in range(-md, md + 1))
    nx = sum(((c - du >= 0) & (c - du < w)).long() for du in range(-md, md + 1))
    reads = 2 * C_ * int((hole.long() * ny[:, None] * nx[None, :]).sum())
    if flow is None:
        return reads, 0, B_ * h * w
    fx = c[None, None, :] + flow[:, 0]
    fy = r[None, :, None] + flow[:, 1]
    valid = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)
    return reads, C_ * int((hole & valid).sum()), B_ * h * w


def _disp_bwd_variants(dout, x, y, flow, md):
    """The captured level, and copies whose flow sends a band of samples off
    the frame and whose y holds all-zero regions (warp holes)."""
    out = {"captured": (dout, x, y, flow, md)}
    B_, C_, h, w = y.shape
    holes = y.clone()
    holes[:, :, h // 4:h // 2, w // 4:w // 2] = 0
    holes[:, :, :, : max(w // 16, 1)] = 0
    off = None
    if flow is not None:
        off = flow.clone()
        off[:, 0, :, -max(w // 8, 1):] += 2.0 * w
        off[:, 1, : max(h // 8, 1)] -= 1.5 * h
    out["edges and holes"] = (dout, x, holes, off, md)
    return out


def phase_displacement_backward(captured, sweep_warp, dicl, old_source: str | None = None):
    """The displacement volume's backward kernel against its plain version
    (`models/dicl.py::displacement_volume_backward_plain`) on the gradients
    and inputs the flow-training step gave it at its five levels, in bf16
    and float32, on copies with out-of-frame samples and all-zero regions
    of y, and at md 0 and 4 at the two finest levels' shapes (random
    gradients); two launches on the same inputs. Then per level, as the
    main path ran them: device time (torch.profiler, every kernel, fill and
    cast of the call) and events time, the bound (the dout elements the
    data needs, y, flow, dx and dy once) and share of it, the plain
    version's time, and two yardsticks the port never calls: autograd of
    the eager composition (`shifted_pairs` over the plain gather's warp,
    its backward alone) and `grid_sampler_2d_backward`'s input gradient for
    the scatter half; the device operations a call puts on the card (the
    buffer's memset, the kernel, the cast). With `old_source`, an earlier
    `sweep_warp.cu`'s backward (the first kernel, with its hole launch)
    checked against the current one and timed with it in turns per level
    (old, new, new, old: events and device time).

    Tolerances: dx bit for bit (the kernel and the plain version add the
    same float32 terms in the same order, cast once); dy bit for bit
    without a flow; with one, the scatter's float32 atomics add in another
    order than `index_add_`, so within 1e-5 of the tensor's largest
    element in float32 and one bf16 ulp there (2^-7 of it) in bf16; the
    same between two launches (dx bit for bit)."""
    worst = {"dx": 0.0, "dy": 0.0}
    max_err = 0.0
    g = torch.Generator(device=captured[0][0].device).manual_seed(12)
    cases = []
    for dout, x, y, flow, md in captured:
        for name, args in _disp_bwd_variants(dout, x, y, flow, md).items():
            cases.append((f"{name} {tuple(y.shape)} md {md}", args))
    warped = sorted([c for c in captured if c[3] is not None], key=lambda c: -c[2].shape[-1])
    for dout, x, y, flow, _ in warped[:2]:
        for md in (0, 4):
            S = 2 * md + 1
            d = torch.randn((*y.shape[:1], S * S, 2 * y.shape[1], *y.shape[2:]), device=y.device,
                            generator=g).to(y.dtype)
            cases.append((f"random md {md} {tuple(y.shape)}", (d, x, y, flow, md)))
    for name, (dout, x, y, flow, md) in cases:
        for dtype in (torch.bfloat16, torch.float32):
            d_, x_, y_ = dout.to(dtype), x.to(dtype), y.to(dtype)
            dx, dy = sweep_warp.displacement_volume_backward_cuda(d_, y_, flow, md)
            dx2, dy2 = sweep_warp.displacement_volume_backward_cuda(d_, y_, flow, md)
            px, py = dicl.displacement_volume_backward_plain(d_, x_, y_, flow, md)
            what = f"displacement backward {name} {str(dtype)[6:]}"
            tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            check(torch.equal(dx, px), f"{what}: dx differs from plain by "
                  f"{float((dx.float() - px.float()).abs().max())}")
            check(torch.equal(dx, dx2), f"{what}: dx differs between two launches")
            scale = float(py.float().abs().max())
            err = float((dy.float() - py.float()).abs().max())
            again = float((dy.float() - dy2.float()).abs().max())
            max_err = max(max_err, err)
            worst["dy"] = max(worst["dy"], err / scale if scale else err)
            if flow is None:
                check(torch.equal(dy, py) and torch.equal(dy, dy2), f"{what}: dy not exact")
            else:
                check(err <= tol * scale and again <= tol * scale, f"{what}: dy differs from "
                      f"plain by {err}, between launches by {again}, beyond {tol} of {scale}")
            del d_, x_, y_, dx, dy, dx2, dy2, px, py
    log(f"displacement backward: {len(cases)} cases in bf16 and float32: dx == plain and "
        f"bit-identical across launches; dy == plain without a flow, with one within "
        f"tolerance, largest |kernel - plain| / max |plain| {worst['dy']:.2e}")

    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"   # noqa: E731
    old = (old_displacement_backward(Path(old_source))
           if old_source and "void* hole" in Path(old_source).read_text() else None)
    rows = []
    for dout, x, y, flow, md in captured:
        dx, dy = sweep_warp.displacement_volume_backward_cuda(dout, y, flow, md)

        def run():
            sweep_warp.displacement_volume_backward_cuda(dout, y, flow, md)

        ms = cuda_ms(run, reps=20)
        # the memset of the float32 buffer and, in bf16, the cast beside the kernel
        ops = 1 if flow is None else 2 + (dout.dtype != torch.float32)
        profile = _full_profile(run, ops)
        dev_ms, device_ops = _profile_sums(profile)
        kern_ms = (None if profile is None
                   else sum(v[0] for n, v in profile.items() if "displacement_" in n))
        turns = None
        if old is not None:
            ox, oy = old(dout, y, flow, md)
            check(torch.equal(ox, dx), "displacement backward: the earlier kernel's dx differs")
            scale = float(dy.float().abs().max())
            check(float((oy.float() - dy.float()).abs().max()) <= 2.0 ** -7 * scale,
                  "displacement backward: the earlier kernel's dy differs beyond a bf16 ulp")
            turns = {"old": {"events_ms": [], "device_ms": []},
                     "new": {"events_ms": [], "device_ms": []}}
            fns = {"old": lambda: old(dout, y, flow, md), "new": run}
            # the earlier operator: its hole launch and kernel, with a flow
            # the zero fill and the cast
            n_ops = {"old": 2 if flow is None else 4, "new": ops}
            for who in ("old", "new", "new", "old"):
                turns[who]["events_ms"].append(cuda_ms(fns[who], reps=20))
                turns[who]["device_ms"].append(
                    _profile_sums(_full_profile(fns[who], n_ops[who]))[0])
            del ox, oy
        plain_ms = cuda_ms(lambda: dicl.displacement_volume_backward_plain(dout, x, y, flow, md),
                           reps=3, warmup=1)
        # yardstick 1: autograd of the eager composition, its backward alone
        xr, yr = x.detach().clone().requires_grad_(), y.detach().clone().requires_grad_()
        with torch.enable_grad():
            stack = dicl.shifted_pairs(xr, yr if flow is None else dicl.warp_flow(
                yr, flow, dicl.bilinear_sample_plain), md)

        def eager():
            torch.autograd.grad(stack, (xr, yr), dout, retain_graph=True)

        eager_ms = cuda_ms(eager, reps=3, warmup=1)
        eager_dev = _profile_sums(_full_profile(eager, reps=3))[0]
        del stack
        # yardstick 2: grid_sampler_2d_backward's input gradient, the scatter half
        grid_ms = grid_dev = None
        if flow is not None:
            B_, C_, h, w = y.shape
            pg = torch.stack(torch.meshgrid(torch.arange(h, device=y.device),
                                            torch.arange(w, device=y.device), indexing="ij")[::-1])
            co = pg[None].float() + flow
            grid = torch.stack([co[:, 0] / (w - 1) * 2 - 1, co[:, 1] / (h - 1) * 2 - 1],
                               dim=-1).to(y.dtype)
            gout = torch.randn(y.shape, device=y.device, generator=g).to(y.dtype)

            def scatter():
                torch.ops.aten.grid_sampler_2d_backward(gout, y, grid, 0, 0, True,
                                                        [True, False])

            grid_ms = cuda_ms(scatter, reps=20)
            grid_dev = _profile_sums(_full_profile(scatter))[0]
        reads, taps, pixels = _disp_bwd_need(y, flow, md, dicl)
        ins = (y,) if flow is None else (y, flow)
        nbytes = (reads * dout.element_size()
                  + sum(t.numel() * t.element_size() for t in ins + (dx, dy)))
        flops = (DISP_BWD_FLOPS_PER_READ * reads + 4 * DISP_BWD_FLOPS_PER_TAP * taps
                 + (0 if flow is None else B1_FLOPS_PER_OUTPUT * pixels))
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        rows.append(dict(name=f"level_{tuple(y.shape[-2:])}", dout=list(dout.shape), md=md,
                         flow=flow is not None, dtype=str(dout.dtype).replace("torch.", ""),
                         ms=ms, device_ms=dev_ms, kernels_device_ms=kern_ms, plain_ms=plain_ms,
                         library_ms=None, eager_autograd_ms=eager_ms,
                         eager_autograd_device_ms=eager_dev, grid_sampler_backward_ms=grid_ms,
                         grid_sampler_backward_device_ms=grid_dev, bound_ms=bound,
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bound_share=None if dev_ms is None else bound / dev_ms, bytes=nbytes,
                         flops=flops, dout_read_share=reads / dout.numel(),
                         device_ops_per_call=device_ops, turns=turns))
        r = rows[-1]
        share = "not measured" if dev_ms is None else f"{100 * bound / dev_ms:.1f}%"
        log(f"displacement backward dout {tuple(dout.shape)} {r['dtype']} "
            f"{'with' if flow is not None else 'without'} flow: device {fmt(dev_ms)} in "
            f"{device_ops} device operations (the kernel {fmt(kern_ms)}), events {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({r['bound_by']}, {nbytes / 1e6:.1f} MB, {100 * r['dout_read_share']:.1f}% "
            f"of dout needed), share of bound {share}; yardsticks: eager autograd events "
            f"{eager_ms:.4f} ms, device {fmt(eager_dev)}; grid_sampler_2d_backward input "
            f"gradient events {fmt(grid_ms)}, device {fmt(grid_dev)}")
        if turns is not None:
            order = (("old", 0), ("new", 0), ("new", 1), ("old", 1))
            log("  in turns (old, new, new, old): events "
                + " / ".join(_fmt_ms(turns[w]["events_ms"][i]) for w, i in order)
                + "; device " + " / ".join(_fmt_ms(turns[w]["device_ms"][i]) for w, i in order))
        del dx, dy
    total = _pair_sums(rows)
    for key in ("eager_autograd_ms", "eager_autograd_device_ms", "kernels_device_ms"):
        vals = [r[key] for r in rows]
        total[key] = None if any(v is None for v in vals) else sum(vals)
    grid_rows = [r for r in rows if r["flow"]]
    total["grid_sampler_backward_ms"] = sum(r["grid_sampler_backward_ms"] for r in grid_rows)
    total["grid_sampler_backward_device_ms"] = (
        None if any(r["grid_sampler_backward_device_ms"] is None for r in grid_rows)
        else sum(r["grid_sampler_backward_device_ms"] for r in grid_rows))
    total["bound_share"] = (None if total["device_ms"] is None
                            else total["bound_ms"] / total["device_ms"])
    total["device_ops_per_step"] = _sum_or_none(r["device_ops_per_call"] for r in rows)
    if old is not None:
        total["turns"] = {w: {k: [_sum_or_none(r["turns"][w][k][i] for r in rows)
                                  for i in (0, 1)]
                              for k in ("events_ms", "device_ms")} for w in ("old", "new")}
        t = total["turns"]
        two = lambda w, k: " / ".join(_fmt_ms(v) for v in t[w][k])   # noqa: E731
        log(f"displacement backward per step in turns with {old_source}: old device "
            f"{two('old', 'device_ms')}, new {two('new', 'device_ms')}; events old "
            f"{two('old', 'events_ms')}, new {two('new', 'events_ms')}")
    share = ("not measured" if total["bound_share"] is None
             else f"{100 * total['bound_share']:.1f}%")
    log(f"displacement backward per flow-training step: device {fmt(total['device_ms'])} in "
        f"{total['device_ops_per_step']} device operations, share of bound {share}, events "
        f"{total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms, plain {total['plain_ms']:.4f} "
        f"ms; eager autograd device {fmt(total['eager_autograd_device_ms'])}; "
        f"grid_sampler_2d_backward (warped levels) device "
        f"{fmt(total['grid_sampler_backward_device_ms'])}")
    return dict(total, calls=rows), max_err


# slice 15: RAFT, the JAX package's default flow estimator, through `cli -v`
# and `cli --train-flow`; kernels R1 (the correlation lookup, all levels in
# one launch an iteration) and R2 (its backward), `csrc/raft_lookup.cu`
RAFT_SOURCE = f"{PKG}/csrc/raft_lookup.cu"
RAFT_REPLACES = ("deep_sfm_revisited_tpu/models/raft.py:127 (lookup_correlation: XLA one-hot "
                 "matmuls; no TPU kernel)")
RAFT_EVAL_ITERS, RAFT_TRAIN_ITERS, RAFT_RADIUS = 24, 12, 4
RAFT_FLOW_WARMUP, RAFT_FLOW_STEPS = 3, 6   # phase 26's untimed and timed steps
RAFT_FLOW_PAIRS = TRAIN_B * (RAFT_FLOW_WARMUP + RAFT_FLOW_STEPS)
# B1's six kernels, B2, its backward, the warped correlation, its backward, R1, R2
RAFT_EVAL_PER_PAIR = (0, SWEEP_PER_PAIR, 0, 0, 0, 0, 0, 0, 0, 0, RAFT_EVAL_ITERS, 0)
RAFT_FLOW_PER_STEP = (0,) * 10 + (RAFT_TRAIN_ITERS, RAFT_TRAIN_ITERS)


def _all_counters(sweep_warp, local_corr, raft_lookup):
    """Every kernel's launch count: B1's six, B2, its backward, the warped
    correlation, its backward, R1, R2."""
    return (sweep_warp.KERNEL, sweep_warp.VOLUME, sweep_warp.VOLUME_BACKWARD,
            sweep_warp.VOLUME_POSE_GRAD, sweep_warp.DISPLACEMENT,
            sweep_warp.DISPLACEMENT_BACKWARD, local_corr.KERNEL, local_corr.KERNEL_BACKWARD,
            local_corr.WARPED, local_corr.WARPED_BACKWARD, raft_lookup.LOOKUP,
            raft_lookup.LOOKUP_BACKWARD)


def phase_small_raft_reference(dev, raft_lookup) -> None:
    """RAFT on the card against RAFT on the CPU (the plain lookup and its
    plain backward there), float32, TF32 off, same weights and inputs, at
    128x128: the flow net alone in eval mode (24 iterations), the flow to
    1e-3 px or to twice the CPU's own move under rounding-sized changes of
    the input, whichever is larger (the pyramid is bf16: a correlation that
    float32 noise puts on a bf16 rounding boundary rounds either way); then
    one `FlowTrainer` step with `flow.estimator=RAFT` (12 iterations, b =
    2): the loss and EPE to 1e-4 relative, the clipped gradients within
    twice the CPU's own relative L2 move at perturbed inputs, 1 - cosine <=
    1e-4. The card's eval launches R1 24 times and R2 never, its step R1
    and R2 12 times each."""
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.train.flow_trainer import FlowTrainer, build_flow_model

    what = "small RAFT reference"
    cfg = SfMConfig.kitti().override(**{"train.mixed_prec": False, "flow.estimator": "RAFT"})
    h = w = 128
    g = torch.Generator().manual_seed(17)
    ref = torch.rand((2, h, w, 3), generator=g) * 2 - 1
    tgt = torch.roll(ref, (2, 3), dims=(1, 2)) + 0.05 * torch.randn((2, h, w, 3), generator=g)
    batch = {"ref": ref, "target": tgt,
             "flow_gt": torch.tensor([3.0, 2.0]) + torch.randn((2, h, w, 2), generator=g),
             "flow_valid": torch.rand((2, h, w), generator=g) < 0.7}
    noise = torch.randn((2, h, w, 3), generator=g)
    counters = (raft_lookup.LOOKUP, raft_lookup.LOOKUP_BACKWARD)
    perturbed = (dict(scale=1 + 1e-6), dict(scale=1 - 1e-6), dict(eps=1e-7), dict(eps=-1e-7))

    def flow(device, scale=1.0, eps=0.0):
        net = build_flow_model(cfg.flow, seed=3).to(device).eval()
        pair = torch.cat([ref[:1] * scale + eps * noise[:1], tgt[:1]], dim=-1).to(device)
        with torch.no_grad():
            return net(pair)[0].cpu()

    before = _launches(*counters)
    f_card = flow(dev)
    torch.cuda.synchronize()
    n = tuple(a - b for a, b in zip(_launches(*counters), before))
    check(n == (RAFT_EVAL_ITERS, 0), f"{what}: eval launched R1, R2 {n} times")
    f_cpu = flow("cpu")
    self_move = max(float((flow("cpu", **kw) - f_cpu).abs().max()) for kw in perturbed)
    f_err = float((f_card - f_cpu).abs().max())
    check(torch.isfinite(f_card).all(), f"{what}: non-finite flow on the card")
    log(f"{what}: eval flow (max |flow| {float(f_cpu.abs().max()):.3f} px) max |card - cpu| "
        f"{f_err:.3e} px, the CPU's own move at perturbed inputs {self_move:.3e} px; launches "
        f"(R1, R2) {n}")
    check(f_err <= max(1e-3, 2 * self_move), f"{what}: eval flow differs by {f_err} px")

    def step(device, scale=1.0, eps=0.0):
        t = FlowTrainer(build_flow_model(cfg.flow, seed=3).to(device), cfg, total_steps=40)
        b = {k: v.to(device) for k, v in
             dict(batch, ref=batch["ref"] * scale + eps * noise).items()}
        m = t.train_step(b)
        return ({k: float(v) for k, v in m.items()},
                {k: p.grad.detach().cpu() for k, p in t.model.named_parameters()})

    def l2(got, want):
        a = torch.cat([got[k].double().flatten() for k in want])
        b = torch.cat([want[k].double().flatten() for k in want])
        return float((a - b).norm() / b.norm())

    before = _launches(*counters)
    m_card, g_card = step(dev)
    torch.cuda.synchronize()
    n = tuple(a - b for a, b in zip(_launches(*counters), before))
    check(n == (RAFT_TRAIN_ITERS, RAFT_TRAIN_ITERS), f"{what}: the step launched R1, R2 {n} "
          "times")
    m_cpu, g_cpu = step("cpu")
    self_l2, self_cos = 0.0, 0.0
    for kw in perturbed:
        moved = step("cpu", **kw)[1]
        self_l2 = max(self_l2, l2(moved, g_cpu))
        self_cos = max(self_cos, _grad_report(moved, g_cpu)[1])
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in ("loss", "epe")}
    errs, cos_err = _grad_report(g_card, g_cpu)
    l2_err = l2(g_card, g_cpu)
    worst = max(errs, key=errs.get)
    log(f"{what}: step loss card {m_card['loss']:.7f} vs cpu {m_cpu['loss']:.7f} (relative "
        f"{rel['loss']:.2e}), EPE {m_card['epe']:.6f} vs {m_cpu['epe']:.6f} (relative "
        f"{rel['epe']:.2e}); gradients: relative L2 {l2_err:.2e} against the CPU's own "
        f"{self_l2:.2e} at {len(perturbed)} perturbed inputs, 1 - cosine {cos_err:.2e} (the "
        f"CPU's own {self_cos:.2e}); per tensor worst {errs[worst]:.2e} ({worst}); launches "
        f"(R1, R2) {n}")
    check(all(math.isfinite(v) for v in m_card.values()), f"{what}: metrics {m_card}")
    check(max(rel.values()) <= 1e-4, f"{what}: loss or EPE differs: {rel}")
    check(all(g_.abs().max() > 0 for g_ in g_card.values()), f"{what}: a RAFT parameter got no "
          "gradient on the card")
    check(l2_err <= 2 * self_l2, f"{what}: the gradients differ by {l2_err} (relative L2), "
          f"beyond twice the CPU's own {self_l2}")
    check(cos_err <= 1e-4, f"{what}: 1 - cosine of the gradients {cos_err}")


def phase_cli_raft(dev, sweep_warp, local_corr, raft_lookup):
    """Slice 15's eval path, through the entry point a user calls: the
    golden KITTI raw tree of phase 5 evaluated by `cli.main([... "-v",
    "--override", "flow.estimator=RAFT", ...])` (RAFT, 24 iterations ->
    uniform sampler -> the 512x5 RANSAC -> PSNet, padded to 384x1280, bf16).
    `SFMNet.forward` is wrapped as in phase 5: the warm-up pair records R1's
    inputs (the pyramid, once, and each iteration's coordinates), then each
    of the three test pairs must launch R1 24 times, the sweep once and no
    other kernel; the 9 Eigen metrics, finite; ms per pair and the flow /
    pose / depth split by CUDA events. Returns the launches over the test
    pairs (`_all_counters`' order) and the captured (levels, [coords],
    out dtype)."""
    from deep_sfm_revisited_tpu_torch import cli
    from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_raw_tree
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet

    what = "cli RAFT"
    rows, timer, cap = [], [], {"coords": []}
    real_forward, launch = SFMNet.forward, raft_lookup.raft_lookup_cuda
    counters = _all_counters(sweep_warp, local_corr, raft_lookup)

    def record(coords, levels, radius, out_dtype):
        if "levels" not in cap:
            cap.update(levels=list(levels), out_dtype=out_dtype)
        check(all(a is b for a, b in zip(levels, cap["levels"])), f"{what}: the pyramid "
              "changed between iterations of one pair")
        cap["coords"].append(coords.clone())
        return launch(coords, levels, radius, out_dtype)

    def timed_forward(model, *args, **kw):
        warm = not timer
        if warm:
            timer.append(StageTimer(model))
            raft_lookup.raft_lookup_cuda = record
        before = _launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = real_forward(model, *args, **kw)
            torch.cuda.synchronize()
        finally:
            raft_lookup.raft_lookup_cuda = launch
        ms = 1e3 * (time.perf_counter() - t0)
        n = tuple(a - b for a, b in zip(_launches(*counters), before))
        i = len(rows) + (0 if warm else 1)
        _check_pair(out, i)
        check(out["num_matches"] is None, f"{what} pair {i}: the sampler reported confidences")
        check(n == RAFT_EVAL_PER_PAIR, f"{what} pair {i}: launches {n}, expected "
              f"{RAFT_EVAL_PER_PAIR}")
        if warm:
            for k in counters:
                k.launches = 0
            log(f"{what}: warm-up pair {ms:.1f} ms; R1 inputs: levels "
                f"{[tuple(t.shape) for t in cap['levels']]} {cap['levels'][0].dtype}, "
                f"{len(cap['coords'])} coordinate maps {tuple(cap['coords'][0].shape)}, out "
                f"{cap['out_dtype']}")
        else:
            rows.append(dict(ms=ms, **timer[0].stages_ms(), inliers=int(out["inliers"][0])))
            r = rows[-1]
            log(f"{what}: pair {i}: {ms:.1f} ms (flow {r['flow']:.1f}, pose {r['pose']:.1f}, "
                f"depth {r['depth']:.1f} ms device); inliers {r['inliers']}/"
                f"{BENCH_OVERRIDES['pose.num_correspondences']}; launches {n}")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti_raw"
        t0 = time.perf_counter()
        write_kitti_raw_tree(root, n_frames=PAIRS + 2, hw=(370, 1224),
                             focal=K_KITTI[0][0], n_test=PAIRS + 1)
        log(f"{what}: golden tree of {PAIRS + 2} 370x1224 frames rendered in "
            f"{time.perf_counter() - t0:.2f} s")
        argv = ["--data", root, "--cfg", "kitti", "-v", "--gt-depth-dir", f"{root}/gt_depth",
                "--out", f"{tmp}/out", "--workers", "4", "--override", "flow.estimator=RAFT",
                *[f"{k}={v}" for k, v in BENCH_OVERRIDES.items()]]
        log(f"{what}: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        torch.cuda.reset_peak_memory_stats()
        for k in counters:
            k.launches = 0
        SFMNet.forward = timed_forward
        try:
            t0 = time.perf_counter()
            results = cli.main(argv)
            wall = time.perf_counter() - t0
        finally:
            SFMNet.forward = real_forward
        launches = _launches(*counters)
    check(len(rows) == PAIRS, f"{what}: {len(rows)} test pairs after the warm-up")
    check(launches == tuple(PAIRS * n for n in RAFT_EVAL_PER_PAIR),
          f"{what}: the test pairs launched {launches}")
    check(len(cap["coords"]) == RAFT_EVAL_ITERS, f"{what}: {len(cap['coords'])} recorded R1 calls")
    check(set(results) == EIGEN_KEYS, f"{what}: metrics {sorted(results)}")
    check(all(math.isfinite(v) for v in results.values()), f"{what}: metrics {results}")
    mean = {k: sum(r[k] for r in rows) / PAIRS for k in ("ms", "flow", "pose", "depth")}
    log(f"{what}: metrics {json.dumps(results)}")
    log(f"{what}: mean over {PAIRS} pairs: {mean['ms']:.2f} ms/pair ({1e3 / mean['ms']:.3f} "
        f"pairs/s); stages flow {mean['flow']:.2f}, pose {mean['pose']:.2f}, depth "
        f"{mean['depth']:.2f} ms; cli.main {wall:.2f} s for {PAIRS + 1} pairs; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{what} rows: " + json.dumps(rows))
    return launches, cap


def _raft_taps(coords, shapes) -> int:
    """The taps of every (query, level) patch that lie on its level, for
    coordinates (B, h, w, 2) and level shapes (Hl, Wl): what the lookup
    must read of the pyramid (a query reads only its own rows, so no tap is
    shared). The window's corner is the kernels' (clip, then floor)."""
    flat = coords.reshape(-1, 2).float()
    r, S = RAFT_RADIUS, 2 * RAFT_RADIUS + 2
    total = 0
    for i, (hl, wl) in enumerate(shapes):
        c = flat / (2.0 ** i)
        n = []
        for k, size in ((0, wl), (1, hl)):
            lo = torch.floor(c[:, k].clamp(-(r + 2.0), size + r + 1.0) - r)
            n.append((torch.minimum(lo + S, torch.full_like(lo, size))
                      - torch.clamp(lo, min=0)).clamp(min=0))
        total += int((n[0] * n[1]).sum())
    return total


def _raft_bound(coords, shapes, level_bytes, grad_bytes, backward, dense=False):
    """(bytes, flops) one launch must move and compute at least. R1: the
    coordinates and the in-frame taps read once, the window written once;
    per (query, level) ~16 float32 operations for the clip and weights and
    7 a window channel. R2: the coordinates, dout and the in-frame taps
    (the coordinates' gradient needs them) read once, the coordinates'
    gradient written once, and the accumulators' in-frame patch elements
    read and written once; with `dense` (the earlier interface) the dense
    gradient of every level written once instead; per (query, level) ~30
    operations, 8 a window channel and 8 a patch tap."""
    Q, L = coords.numel() // 2, len(shapes)
    D, S = 2 * RAFT_RADIUS + 1, 2 * RAFT_RADIUS + 2
    window = Q * L * D * D * grad_bytes
    taps = _raft_taps(coords, shapes) * level_bytes
    nbytes = coords.numel() * 4 + taps + window
    if not backward:
        return nbytes, Q * L * (16 + 7 * D * D)
    levels = sum(h * w for h, w in shapes) * Q * level_bytes if dense else 2 * taps
    return nbytes + coords.numel() * 4 + levels, Q * L * (30 + 8 * D * D + 8 * S * S)


def _raft_sector_bytes(coords, levels) -> int:
    """The bytes of the 32-byte sectors that the in-frame tap rows of every
    (query, level) touch, at the addresses of `levels` (the pyramid, or
    accumulators of its shapes): the rows' cost at the granularity the
    memory serves them in."""
    flat = coords.reshape(-1, 2).float()
    r, S = RAFT_RADIUS, 2 * RAFT_RADIUS + 2
    q = torch.arange(flat.shape[0], device=flat.device)
    total = 0
    for i, lv in enumerate(levels):
        hl, wl = lv.shape[1:]
        isz = lv.element_size()
        c = flat / (2.0 ** i)
        x0 = torch.floor(c[:, 0].clamp(-(r + 2.0), wl + r + 1.0) - r).long()
        y0 = torch.floor(c[:, 1].clamp(-(r + 2.0), hl + r + 1.0) - r).long()
        xa, xb = x0.clamp(min=0), (x0 + S).clamp(max=wl)
        ys = y0[:, None] + torch.arange(S, device=flat.device)
        ok = (ys >= 0) & (ys < hl) & (xb > xa)[:, None]
        row = (q[:, None] * hl + ys) * wl
        start = lv.data_ptr() + (row + xa[:, None]) * isz
        end = lv.data_ptr() + (row + xb[:, None]) * isz
        total += int(((end - 1) // 32 - start // 32 + 1)[ok].sum()) * 32
    return total


def old_raft(path: Path):
    """R1 and R2 of an earlier `raft_lookup.cu` (one block a query; R2
    writes every level's gradient densely, `write_grad_row`),
    built by `ops/cuda/build.py` beside the current source and called
    through ctypes as that source's operators called them. Returns (r1,
    r2): r1(coords, levels, radius, out_dtype) -> out; r2(coords, levels,
    dout, radius) -> (d coords, [dense d level])."""
    import ctypes

    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    check("write_grad_row" in path.read_text(),
          f"{path} is not a source whose R2 writes dense level gradients")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    class OldRaft(CudaKernel):
        source = str(path.resolve())   # an absolute path replaces csrc/

        def _bind(self, lib):
            lib.dsfm_raft_lookup.argtypes = [P, P, P, I, P, P, LL, I, I, I, P]
            lib.dsfm_raft_lookup.restype = I
            lib.dsfm_raft_lookup_backward.argtypes = [P, P, P, P, I, P, P, P, LL, I, I, I, P]
            lib.dsfm_raft_lookup_backward.restype = I

    lib = OldRaft().build()

    def table(tensors, kind=P, attr=None):
        vals = [t.data_ptr() if attr is None else attr(t) for t in tensors]
        return ctypes.cast((kind * len(vals))(*vals), P)

    def shapes(levels):
        return (table(levels), table(levels, I, lambda t: t.shape[1]),
                table(levels, I, lambda t: t.shape[2]))

    def r1(coords, levels, radius, out_dtype):
        ptrs, hs, ws = shapes(levels)
        out = torch.empty((*coords.shape[:3], len(levels) * (2 * radius + 1) ** 2),
                          dtype=out_dtype, device=coords.device)
        err = lib.dsfm_raft_lookup(ptrs, hs, ws, len(levels), coords.data_ptr(), out.data_ptr(),
                                   coords.numel() // 2, radius,
                                   int(levels[0].dtype == torch.bfloat16),
                                   int(out_dtype == torch.bfloat16),
                                   torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"{path}'s R1 launch failed: cudaError {err}")
        return out

    def r2(coords, levels, dout, radius):
        ptrs, hs, ws = shapes(levels)
        grads = [torch.empty_like(t) for t in levels]
        dc = torch.empty_like(coords)
        err = lib.dsfm_raft_lookup_backward(
            ptrs, table(grads), hs, ws, len(levels), coords.data_ptr(), dout.data_ptr(),
            dc.data_ptr(), coords.numel() // 2, radius, int(levels[0].dtype == torch.bfloat16),
            int(dout.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"{path}'s R2 launch failed: cudaError {err}")
        return dc, grads

    return r1, r2


def _tail(coords, levels, dout=None, n=7332):
    """The first `n` queries (376x1248's 47 x 156 at 1/8: no multiple of the
    queries a block) as a (1, 1, n) problem of their own."""
    c = coords.reshape(1, 1, -1, 2)[:, :, :n].contiguous()
    lv = [t[:n] for t in levels]
    return (c, lv) if dout is None else (c, lv, dout.reshape(1, 1, -1, dout.shape[-1])[:, :, :n]
                                         .contiguous())


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _raft_edge_coords(coords, levels):
    """A copy of `coords` whose first queries sit exactly on each level's
    clip bounds, one float32 step inside and outside them, far off the
    frame both ways and on integer positions."""
    c = coords.clone()
    flat = c.view(-1, 2)
    q = 0
    for i, lv in enumerate(levels):
        for k, size in ((0, lv.shape[2]), (1, lv.shape[1])):
            for v in (-(RAFT_RADIUS + 2) * 2.0 ** i, (size + RAFT_RADIUS + 1) * 2.0 ** i):
                v = torch.tensor(v, dtype=torch.float32)
                for u in (v, torch.nextafter(v, v + 1), torch.nextafter(v, v - 1)):
                    flat[q, k] = u
                    q += 1
    for v in (-1000.0, 1000.0, 0.0, 5.0):
        flat[q] = v
        q += 1
    return c


def _raft_grids(coords, levels):
    """Upstream RAFT's lookup as `F.grid_sample` takes it (align_corners,
    zero padding): per level the (Q, 9, 9, 2) grid of the window around
    coords / 2^i, normalised to [-1, 1], in the levels' dtype."""
    r = RAFT_RADIUS
    d = torch.arange(-r, r + 1, device=coords.device, dtype=torch.float32)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dx, dy], dim=-1)
    grids = []
    for i, lv in enumerate(levels):
        hl, wl = lv.shape[1:]
        c = coords.reshape(-1, 1, 1, 2) / 2 ** i + delta
        grid = torch.stack([2 * c[..., 0] / max(wl - 1, 1) - 1, 2 * c[..., 1] / max(hl - 1, 1) - 1],
                           dim=-1)
        grids.append(grid.to(lv.dtype))
    return grids


def phase_raft_lookup(cap, raft_lookup, raft, old_source=None):
    """R1 against its plain version (`models/raft.py::lookup_correlation_plain`)
    on the pyramid and each of the 24 coordinate maps phase 24's warm-up pair
    gave it, in the network's dtype (bf16) and in float32, bit for bit at
    every level (both round op by op in one order), on the first 7332
    queries (a tail block) and on a copy whose queries sit on the clip's
    bounds, beyond them and off the frame; two launches bit-identical. Per
    pair (24 launches): device ms (torch.profiler) or "not
    measured" where every trace is refused, CUDA-graph and events ms, the
    bound (the window written once, the in-frame taps and the coordinates
    read once) and the same with the taps counted in the 32-byte sectors
    their rows touch, the plain version's ms and the yardstick the port
    never calls, `F.grid_sample` (align_corners, zeros) over the four
    levels, upstream RAFT's own lookup (96 calls a pair). With `old_source`
    (an earlier `raft_lookup.cu`, one block a query) its R1, bit for bit
    the current one and timed in turns (old, new, new, old) by CUDA graph,
    on the device and by events (host included: the earlier kernel is
    launched through ctypes here, not through its own operator, so its
    events time is not its wrapper's; `raft_compare.py --host-tree`
    compares two checkouts' wrappers)."""
    what = "R1 (RAFT lookup)"
    levels, coords, od = cap["levels"], cap["coords"], cap["out_dtype"]
    shapes = [tuple(t.shape[1:]) for t in levels]
    K = (2 * RAFT_RADIUS + 1) ** 2
    max_err = 0.0
    tail_c, tail_lv = _tail(coords[-1], levels)
    cases = [(c, levels, od, "captured") for c in coords]
    cases += [(coords[-1], levels, torch.float32, "captured, float32 out"),
              (tail_c, tail_lv, od, f"the first {tail_c.shape[2]} queries (a tail block)"),
              (tail_c, tail_lv, torch.float32, "a tail block, float32 out"),
              (_raft_edge_coords(coords[-1], levels), levels, od, "clip bounds and off the frame"),
              (_raft_edge_coords(coords[0], levels), levels, torch.float32, "bounds, float32 out")]
    for c, lv, dtype, kind in cases:
        got = raft_lookup.raft_lookup_cuda(c, lv, RAFT_RADIUS, dtype)
        want = raft.lookup_correlation_plain(lv, c, RAFT_RADIUS).to(dtype)
        for i in range(len(lv)):
            sl = slice(i * K, (i + 1) * K)
            err = float((got[..., sl].float() - want[..., sl].float()).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got[..., sl], want[..., sl]), f"{what} {kind}: level {i} differs "
                  f"from the plain version by {err}")
        check(torch.equal(got, raft_lookup.raft_lookup_cuda(c, lv, RAFT_RADIUS, dtype)),
              f"{what} {kind}: two launches differ")
    log(f"{what}: {len(cases)} cases (the warm-up pair's {len(coords)} coordinate maps in "
        f"{od}, float32 out, a tail block, clip bounds and off-frame) bit for bit the plain "
        "version at every level; two launches bit-identical")

    def run():
        for c in coords:
            raft_lookup.raft_lookup_cuda(c, levels, RAFT_RADIUS, od)

    def plain():
        for c in coords:
            raft.lookup_correlation_plain(levels, c, RAFT_RADIUS).to(od)

    chosen = raft_lookup.R1_QUERIES
    ms = cuda_ms(run, reps=5)
    graph = graph_ms(run, reps=2)
    dev_ms = device_ms(run, "raft_lookup_kernel", reps=5)
    plain_ms = cuda_ms(plain, reps=1, warmup=1)
    grids = [_raft_grids(c, levels) for c in coords]
    inputs = [lv[:, None] for lv in levels]
    try:
        F.grid_sample(inputs[0], grids[0][0], align_corners=True)
    except RuntimeError as e:   # a yardstick the port never calls: in float32 where it must
        log(f"{what}: F.grid_sample refuses {levels[0].dtype} ({e}); timed in float32")
        grids = [[gr.float() for gr in gs] for gs in grids]
        inputs = [t.float() for t in inputs]

    def library():
        for gs in grids:
            for lv, gr in zip(inputs, gs):
                F.grid_sample(lv, gr, align_corners=True)

    lib_ms = cuda_ms(library, reps=3)
    lib_dev = _profile_sums(_full_profile(library, reps=3))[0]
    del grids, inputs
    isz = levels[0].element_size()
    osz = torch.empty((), dtype=od).element_size()
    nbytes, flops = (sum(v) for v in zip(*(_raft_bound(c, shapes, isz, osz, False)
                                          for c in coords)))
    taps = sum(_raft_taps(c, shapes) for c in coords)
    sector_bytes = nbytes - taps * isz + sum(_raft_sector_bytes(c, levels) for c in coords)
    Q = coords[0].numel() // 2
    ops_ms = flops / F32_FLOPS * 1e3
    bound, bound_by = _bound_ms(nbytes, ops_ms)
    sector_bound = _bound_ms(sector_bytes, ops_ms)[0]
    share = "not measured" if dev_ms is None else f"{100 * bound / dev_ms:.1f}%"
    log(f"{what} per eval pair ({len(coords)} launches, Q = {Q}, levels {shapes}, {chosen} "
        f"queries a block): device {_fmt_ms(dev_ms)}, by CUDA graph {graph:.4f} ms, events {ms:.4f} ms; "
        f"bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, of which in-frame taps "
        f"{taps * isz / 1e6:.2f} MB; {flops / 1e6:.1f} MFLOP), share {share} on the device, "
        f"{100 * bound / graph:.1f}% by CUDA graph; at the 32-byte sectors the tap rows touch "
        f"{sector_bound:.4f} ms ({sector_bytes / 1e6:.2f} MB), "
        f"{100 * sector_bound / (dev_ms or graph):.1f}%; plain {plain_ms:.4f} ms; F.grid_sample "
        f"over the four levels {lib_ms:.4f} ms by events, {_fmt_ms(lib_dev)} on the device")
    row = dict(ms=ms, device_ms=dev_ms, graph_ms=graph, plain_ms=plain_ms, bound_ms=bound,
               bound_by=bound_by, sector_bound_ms=sector_bound, sector_bytes=sector_bytes,
               library_ms=lib_ms, library_device_ms=lib_dev, bytes=nbytes, flops=flops,
               launches_per_pair=len(coords), levels=[list(s) for s in shapes], Q=Q,
               queries_a_block=chosen)
    if old_source:
        r1_old, _ = old_raft(Path(old_source))
        for c in coords:
            check(torch.equal(r1_old(c, levels, RAFT_RADIUS, od),
                              raft_lookup.raft_lookup_cuda(c, levels, RAFT_RADIUS, od)),
                  f"{what}: {old_source}'s R1 differs from the current one")

        def run_old():
            for c in coords:
                r1_old(c, levels, RAFT_RADIUS, od)

        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            fn = run_old if who == "old" else run
            turns[who].append((graph_ms(fn, reps=2), device_ms(fn, "raft_lookup_kernel", reps=5),
                               cuda_ms(fn, reps=5)))
        row["in_turns"] = {k: {"graph_ms": [t[0] for t in v], "device_ms": [t[1] for t in v],
                               "events_ms": [t[2] for t in v]} for k, v in turns.items()}
        log(f"{what}: {old_source} bit for bit the current kernel; in turns old, new, new, old "
            f"per pair: by CUDA graph old {[round(t[0], 4) for t in turns['old']]}, new "
            f"{[round(t[0], 4) for t in turns['new']]} ms; on the device old "
            f"{[_fmt_ms(t[1]) for t in turns['old']]}, new "
            f"{[_fmt_ms(t[1]) for t in turns['new']]}; by events (host included; the old "
            f"kernel through ctypes) old {[round(t[2], 4) for t in turns['old']]}, new "
            f"{[round(t[2], 4) for t in turns['new']]} ms")
    return row, max_err


def phase_cli_train_flow_raft(dev, sweep_warp, local_corr, raft_lookup):
    """Slice 15's training path, through the entry point a user calls:
    `cli.main(["--train-flow", ..., "--flow-crop", "256", "768", "-b", "4",
    "--override", "flow.estimator=RAFT"])` on a KITTI 2015 flow tree of
    RAFT_FLOW_PAIRS pairs rendered at KITTI's 375x1242 (RAFT's pairs are
    padded to /8: 376x1248), RAFT at full width (JAX's `FlowConfig`
    defaults: 12 iterations, radius 4, 4 levels), bf16: RAFT_FLOW_WARMUP
    untimed steps, the first of which records R2's inputs (the pyramid, each
    iteration's coordinates and gradient), then RAFT_FLOW_STEPS timed steps;
    every step must launch R1 and R2 12 times each and no other kernel,
    give a finite loss and EPE and move every RAFT parameter; ms/step
    (median, mean, spread), the stage split (forward, loss + backward,
    AdamW) by CUDA events, peak memory; the validation's EPE and Fl-all
    over the pairs (R1 24 times a pair); `--pretrained-flow` into an SFMNet
    with every RAFT tensor equal and PSNet untouched. Returns (the launches
    after the warm-up, validation included, in `_all_counters`' order; the
    captured R2 calls [(coords, levels, dout)])."""
    from deep_sfm_revisited_tpu_torch import cli
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_flow_tree
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
    from deep_sfm_revisited_tpu_torch.train.flow_trainer import FlowTrainer

    what = "cli train-flow (RAFT)"
    counters = _all_counters(sweep_warp, local_corr, raft_lookup)
    real_step, real_bwd = FlowTrainer.train_step, raft_lookup.raft_lookup_backward_cuda
    rows, timer, captured, calls = [], [], [], []

    def record(coords, levels, dout, radius, grads):
        captured.append((coords.clone(), list(levels), dout.clone()))
        return real_bwd(coords, levels, dout, radius, grads)

    def timed_step(trainer, *args, **kw):
        calls.append(len(calls) + 1)
        first, warm = len(calls) == 1, len(calls) <= RAFT_FLOW_WARMUP
        if first:
            timer.append(FlowStageTimer(trainer))
            raft_lookup.raft_lookup_backward_cuda = record
        model = trainer.model
        state = {k: p.detach().clone() for k, p in model.named_parameters()}
        before = _launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer[0]._mark("step_start")
        try:
            metrics = real_step(trainer, *args, **kw)
        finally:
            raft_lookup.raft_lookup_backward_cuda = real_bwd
        timer[0]._mark("step_end")
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n = tuple(a - b for a, b in zip(_launches(*counters), before))
        i = f"warm-up {calls[-1]}" if warm else f"{len(rows) + 1}"
        loss, epe = float(metrics["loss"]), float(metrics["epe"])
        check(math.isfinite(loss) and math.isfinite(epe), f"{what} step {i}: loss {loss}, "
              f"EPE {epe}")
        check(n == RAFT_FLOW_PER_STEP, f"{what} step {i}: launches {n}, expected "
              f"{RAFT_FLOW_PER_STEP}")
        still = [k for k, p in model.named_parameters() if torch.equal(p, state[k])]
        check(not still, f"{what} step {i}: RAFT parameters did not move: {still[:3]}")
        if warm:
            if first:
                check(len(captured) == RAFT_TRAIN_ITERS, f"{what}: {len(captured)} R2 calls "
                      "recorded")
                c, lv, g = captured[0]
                log(f"{what}: R2 inputs: coords {tuple(c.shape)}, levels "
                    f"{[tuple(t.shape) for t in lv]} {lv[0].dtype}, dout {tuple(g.shape)} "
                    f"{g.dtype} (max |dout| {max(float(x[2].abs().max()) for x in captured):.3e})")
            log(f"{what}: step {i}: {ms:.1f} ms, loss {loss:.4f}, EPE {epe:.4f} (untimed)")
            if calls[-1] == RAFT_FLOW_WARMUP:
                for k in counters:
                    k.launches = 0
                torch.cuda.reset_peak_memory_stats()
        else:
            rows.append(dict(ms=ms, loss=loss, epe=epe, **timer[0].stages_ms()))
            r = rows[-1]
            log(f"{what}: step {i}: {ms:.1f} ms (forward {r['forward']:.1f}, loss + backward "
                f"{r['loss_backward']:.1f}, optimizer {r['optimizer']:.1f} ms device); loss "
                f"{loss:.4f}, EPE {epe:.4f}; launches {n}")
            if len(rows) == RAFT_FLOW_STEPS:
                rows.append(dict(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                 launches=_launches(*counters)))
        return metrics

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti_flow"
        t0 = time.perf_counter()
        write_kitti_flow_tree(root, n_pairs=RAFT_FLOW_PAIRS, hw=FLOW_HW, focal=K_KITTI[0][0])
        log(f"{what}: KITTI flow tree of {RAFT_FLOW_PAIRS} {FLOW_HW[0]}x{FLOW_HW[1]} pairs "
            f"rendered in {time.perf_counter() - t0:.2f} s")
        argv = ["--data", root, "--cfg", "kitti", "--train-flow", "--flow-dataset", "kitti",
                "--flow-crop", str(FLOW_CROP[0]), str(FLOW_CROP[1]), "-b", str(TRAIN_B),
                "--epochs", "1", "--out", f"{tmp}/out", "--workers", "4",
                "--override", "flow.estimator=RAFT"]
        log(f"{what}: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        for k in counters:
            k.launches = 0
        FlowTrainer.train_step = timed_step
        try:
            t0 = time.perf_counter()
            history = cli.main(argv)
            wall = time.perf_counter() - t0
        finally:
            FlowTrainer.train_step = real_step
        launches = _launches(*counters)
        ckpt = f"{tmp}/out/kitti_flow/ckpt"
        check(os.path.exists(f"{ckpt}/0.pt") and os.path.exists(f"{ckpt}/model_best.pt"),
              f"{what}: no checkpoint written")
        cfg = SfMConfig.kitti().override(**{"flow.estimator": "RAFT"})
        model = SFMNet(cfg, device=dev, seed=5)
        psnet = {k: v.clone() for k, v in model.depth_estimator.state_dict().items()}
        cli.apply_pretrained(cli.build_parser().parse_args(
            ["--data", root, "--pretrained-flow", ckpt]), model)
        want = torch.load(f"{ckpt}/0.pt", map_location=dev, weights_only=True)["model"]
        got = model.flow_estimator.state_dict()
        check(set(got) == set(want) and all(torch.equal(got[k], v) for k, v in want.items()),
              f"{what}: --pretrained-flow did not restore every RAFT tensor")
        check(all(torch.equal(v, psnet[k]) for k, v in model.depth_estimator.state_dict().items()),
              f"{what}: --pretrained-flow touched PSNet")
        n_tensors = len(want)
        del model, want, got, psnet
    check(len(rows) == RAFT_FLOW_STEPS + 1, f"{what}: {len(rows) - 1} timed steps")
    tail = rows.pop()
    check(tail["launches"] == tuple(RAFT_FLOW_STEPS * n for n in RAFT_FLOW_PER_STEP),
          f"{what}: the timed steps launched {tail['launches']}")
    rec = history[0] if len(history) == 1 else {}
    check(all(math.isfinite(rec.get(k, math.nan)) for k in ("train_loss", "epe", "f1_all"))
          and rec.get("n") == RAFT_FLOW_PAIRS, f"{what}: epoch record {history}")
    val = tuple(RAFT_FLOW_STEPS * n for n in RAFT_FLOW_PER_STEP)
    val = val[:10] + (val[10] + RAFT_EVAL_ITERS * RAFT_FLOW_PAIRS, val[11])
    check(launches == val, f"{what}: the timed steps and the validation launched {launches}, "
          f"expected {val}")
    mean = {k: sum(r[k] for r in rows) / RAFT_FLOW_STEPS for k in rows[0]}
    ms = sorted(r["ms"] for r in rows)
    median = (ms[(len(ms) - 1) // 2] + ms[len(ms) // 2]) / 2
    log(f"{what}: the timed steps' host ms: median {median:.2f}, min {ms[0]:.2f}, max "
        f"{ms[-1]:.2f}, spread (max - min) / median {(ms[-1] - ms[0]) / median:.3f}")
    log(f"{what}: mean over {RAFT_FLOW_STEPS} steps at b = {TRAIN_B}, {FLOW_CROP[0]}x"
        f"{FLOW_CROP[1]}: {mean['ms']:.2f} ms/step ({1e3 * TRAIN_B / mean['ms']:.3f} pairs/s); "
        f"device stages forward {mean['forward']:.2f}, loss + backward "
        f"{mean['loss_backward']:.2f}, optimizer {mean['optimizer']:.2f} ms (step "
        f"{mean['step']:.2f}); peak memory {tail['peak_gib']:.2f} GiB; cli.main {wall:.2f} s; "
        f"validation over {rec['n']} pairs at {FLOW_HW[0]}x{FLOW_HW[1]}: EPE {rec['epe']:.4f} "
        f"px, Fl-all {rec['f1_all']:.2f}%; train loss {rec['train_loss']:.4f}; "
        f"--pretrained-flow restored all {n_tensors} RAFT tensors into SFMNet, PSNet untouched; "
        f"launches after the warm-up, validation included: {launches}")
    log(f"{what} rows: " + json.dumps(rows))
    return launches, captured


def phase_raft_backward(captured, raft_lookup, raft, old_source=None):
    """R2 against its plain version (`models/raft.py::
    lookup_correlation_backward_accumulate_plain`) on the coordinates,
    pyramid and gradients phase 26's first step gave it (12 calls, b = 4,
    256x768), with the gradient in the network's dtype (bf16) and in
    float32, on a unit-scale random gradient (the captured ones are small,
    so a wrong kernel fails there by many times the limit), on coordinates
    at the clip's bounds and off the frame and on the first 7332 queries (a
    tail block), each adding into accumulators that already hold random
    values: every level's accumulator bit for bit, the coordinates'
    gradient to 1e-5 of its largest value (sums of 81 products in a warp's
    order), two launches bit-identical. The step's whole backward of the
    lookup (one zero fill of the pyramid's accumulators, then the 12
    launches, last iteration first) bit for bit the dense plain gradients
    added in bf16 in that order. Per step: the 12 launches' device ms or "not
    measured", CUDA-graph and events ms, and the whole backward's; the bound
    of this interface (the coordinates, dout and the in-frame taps read,
    the accumulators' in-frame patch elements read and written, d coords
    written) and of the dense one it replaced; the plain version's ms, and
    the yardstick the port never calls: `grid_sampler_2d_backward` (input
    and grid gradients) over the four levels, upstream RAFT's gradient (48
    calls a step); and the bound with the patch rows of the levels and the
    accumulators counted in the 32-byte sectors they touch. With `old_source` (an earlier `raft_lookup.cu` whose R2
    writes each level's gradient densely) its whole backward as autograd
    ran it, 12 dense launches with each level's bf16 `add_` after the
    first, bit for bit the new accumulators and timed in turns (old, new,
    new, old) by CUDA graph and on the device."""
    what = "R2 (RAFT lookup backward)"
    R_ = RAFT_RADIUS
    levels = captured[0][1]
    shapes = [tuple(t.shape[1:]) for t in levels]
    g = torch.Generator(device=levels[0].device).manual_seed(23)
    max_err, shares = 0.0, []
    c0, _, d0 = captured[0]
    unit = torch.randn(d0.shape, generator=g, device=d0.device)
    tail = _tail(c0, levels, unit.to(d0.dtype))
    cases = [(c, levels, d, "captured") for c, _, d in captured]
    cases += [(captured[-1][0], levels, captured[-1][2].float(), "captured, float32 dout"),
              (c0, levels, unit.to(d0.dtype), "unit-scale"),
              (c0, levels, unit, "unit-scale, float32 dout"),
              (_raft_edge_coords(c0, levels), levels, unit.to(d0.dtype),
               "clip bounds and off the frame"),
              (*tail, f"the first {tail[0].shape[2]} queries (a tail block)")]
    for c, lv, d, kind in cases:
        start = [torch.randn(t.shape, generator=g, device=t.device).to(t.dtype) for t in lv]
        acc = [a.clone() for a in start]
        dc = raft_lookup.raft_lookup_backward_cuda(c, lv, d, R_, acc)
        want = [a.clone() for a in start]
        wdc = raft.lookup_correlation_backward_accumulate_plain(lv, c, d, R_, want)
        for i, (a, b) in enumerate(zip(acc, want)):
            err = float((a.float() - b.float()).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(_bits(a), _bits(b)), f"{what} {kind}: level {i}'s accumulator "
                  f"differs from the plain version's by {err}")
        tol = 1e-5 * float(wdc.abs().max())
        err = float((dc - wdc).abs().max())
        max_err = max(max_err, err)
        shares.append(err / tol if tol else 0.0)
        check(err <= tol, f"{what} {kind}: d coords differ by {err}, beyond {tol}")
        acc2 = [a.clone() for a in start]
        dc2 = raft_lookup.raft_lookup_backward_cuda(c, lv, d, R_, acc2)
        check(torch.equal(dc, dc2) and all(torch.equal(_bits(a), _bits(b))
                                           for a, b in zip(acc, acc2)),
              f"{what} {kind}: two launches differ")
        del start, acc, want, acc2
    log(f"{what}: {len(cases)} cases (phase 26's {len(captured)} calls in {d0.dtype}, float32 "
        f"dout, unit-scale, clip bounds and off-frame, a tail block), into accumulators holding "
        f"random values: the accumulators bit for bit the plain version's, d coords within 1e-5 "
        f"of its largest (largest share of that {max(shares):.3f}); two launches bit-identical")

    def whole():
        """The lookup's backward of one step: one zero fill, 12 launches."""
        acc = raft.zeros_like_pyramid(levels)
        for c, lv, d in reversed(captured):
            raft_lookup.raft_lookup_backward_cuda(c, lv, d, R_, acc)
        return acc

    got = whole()
    dense = None
    for c, lv, d in reversed(captured):
        dl, _ = raft.lookup_correlation_backward_plain(lv, c, d, R_)
        dense = dl if dense is None else [a.add_(b) for a, b in zip(dense, dl)]
    check(all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, dense)),
          f"{what}: the step's accumulated gradient differs from the dense plain gradients "
          "added in bf16, last iteration first")
    del dense
    chosen = raft_lookup.R2_QUERIES
    log(f"{what}: the step's whole backward (zero fill + {len(captured)} launches) bit for bit "
        "the dense plain gradients added in bf16, last iteration first")

    acc = raft.zeros_like_pyramid(levels)

    def run():
        for c, lv, d in captured:
            raft_lookup.raft_lookup_backward_cuda(c, lv, d, R_, acc)

    def plain():
        pacc = [torch.zeros_like(t) for t in levels]
        for c, lv, d in captured:
            raft.lookup_correlation_backward_accumulate_plain(lv, c, d, R_, pacc)

    K = (2 * R_ + 1) ** 2
    lib_args = []
    for c, lv, d in captured:
        for i, (t, gr) in enumerate(zip(lv, _raft_grids(c, lv))):
            gout = d[..., i * K:(i + 1) * K].reshape(-1, 1, 2 * R_ + 1, 2 * R_ + 1).to(t.dtype)
            lib_args.append((gout, t[:, None], gr))
    try:
        torch.ops.aten.grid_sampler_2d_backward(*lib_args[0], 0, 0, True, [True, True])
    except RuntimeError as e:   # a yardstick the port never calls: in float32 where it must
        log(f"{what}: grid_sampler_2d_backward refuses {levels[0].dtype} ({e}); timed in "
            "float32")
        lib_args = [tuple(t.float() for t in a) for a in lib_args]

    def library():
        for gout, t, gr in lib_args:
            torch.ops.aten.grid_sampler_2d_backward(gout, t, gr, 0, 0, True, [True, True])

    ms = cuda_ms(run, reps=3)
    graph = graph_ms(run, reps=1)
    dev_ms = device_ms(run, "raft_lookup_backward_kernel", reps=3)
    whole_graph = graph_ms(whole, reps=1)
    whole_ms = cuda_ms(whole, reps=3)
    whole_dev, whole_ops = _profile_sums(_full_profile(whole, ops=len(captured), reps=3))
    plain_ms = cuda_ms(plain, reps=1, warmup=1)
    lib_ms = cuda_ms(library, reps=2, warmup=1)
    lib_dev = _profile_sums(_full_profile(library, reps=2))[0]
    del lib_args
    isz = levels[0].element_size()
    Q = c0.numel() // 2
    nbytes, flops = (sum(v) for v in zip(*(_raft_bound(c, shapes, isz, d.element_size(), True)
                                          for c, _, d in captured)))
    dense_bytes = sum(_raft_bound(c, shapes, isz, d.element_size(), True, dense=True)[0]
                      for c, _, d in captured)
    fill = sum(h * w for h, w in shapes) * Q * isz
    taps = sum(_raft_taps(c, shapes) for c, _, _ in captured) * isz
    sectors = sum(_raft_sector_bytes(c, levels) + 2 * _raft_sector_bytes(c, acc)
                  for c, _, _ in captured)
    sector_bytes = nbytes - 3 * taps + sectors
    ops_ms = flops / F32_FLOPS * 1e3
    bound, bound_by = _bound_ms(nbytes, ops_ms)
    sector_bound = _bound_ms(sector_bytes, ops_ms)[0]
    whole_bound = _bound_ms(nbytes + fill, ops_ms)[0]
    dense_bound = _bound_ms(dense_bytes, ops_ms)[0]
    share = "not measured" if dev_ms is None else f"{100 * bound / dev_ms:.1f}%"
    log(f"{what} per training step ({len(captured)} launches, Q = {Q}, levels {shapes}, "
        f"{chosen} queries a block): device {_fmt_ms(dev_ms)}, by CUDA graph {graph:.4f} ms, "
        f"events {ms:.4f} ms; bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB; "
        f"{flops / 1e6:.1f} MFLOP), share {share} on the device, {100 * bound / graph:.1f}% by "
        f"CUDA graph; at the 32-byte sectors the patch rows of the levels and accumulators "
        f"touch {sector_bound:.4f} ms ({sector_bytes / 1e6:.2f} MB), "
        f"{100 * sector_bound / (dev_ms or graph):.1f}%; the dense interface's bound "
        f"{dense_bound:.4f} ms ({dense_bytes / 1e6:.2f} MB); the whole backward (zero fill of {fill / 1e6:.2f} MB + {len(captured)} launches): "
        f"device {_fmt_ms(whole_dev)} in {whole_ops} device operations, by CUDA graph "
        f"{whole_graph:.4f} ms, events {whole_ms:.4f} ms, bound {whole_bound:.4f} ms; plain "
        f"{plain_ms:.4f} ms; grid_sampler_2d_backward over the four levels {lib_ms:.4f} ms by "
        f"events, {_fmt_ms(lib_dev)} on the device")
    row = dict(ms=ms, device_ms=dev_ms, graph_ms=graph, plain_ms=plain_ms, bound_ms=bound,
               bound_by=bound_by, sector_bound_ms=sector_bound, sector_bytes=sector_bytes,
               dense_bound_ms=dense_bound, library_ms=lib_ms,
               library_device_ms=lib_dev, bytes=nbytes, flops=flops,
               launches_per_step=len(captured), levels=[list(s) for s in shapes], Q=Q,
               queries_a_block=chosen,
               whole_backward=dict(device_ms=whole_dev, device_ops=whole_ops,
                                   graph_ms=whole_graph, events_ms=whole_ms,
                                   bound_ms=whole_bound, fill_bytes=fill))
    if old_source:
        _, r2_old = old_raft(Path(old_source))

        def old_whole():
            """The earlier path: 12 dense launches, autograd's bf16 adds."""
            total = None
            for c, lv, d in reversed(captured):
                dl = r2_old(c, lv, d, R_)[1]
                total = dl if total is None else [a.add_(b) for a, b in zip(total, dl)]
            return total

        check(all(torch.equal(_bits(a), _bits(b)) for a, b in zip(old_whole(), got)),
              f"{what}: {old_source}'s dense gradients added in bf16 differ from the new "
              "accumulators")
        for c, lv, d in captured[:2]:
            want = r2_old(c, lv, d, R_)[0]
            scratch = raft.zeros_like_pyramid(lv)
            err = float((raft_lookup.raft_lookup_backward_cuda(c, lv, d, R_, scratch) - want)
                        .abs().max())
            check(err <= 1e-5 * float(want.abs().max()), f"{what}: d coords differ from "
                  f"{old_source}'s by {err}")
        turns = {"old": [], "new": []}
        n_old = len(captured) + (len(captured) - 1) * len(levels)   # launches, adds
        for who in ("old", "new", "new", "old"):
            fn, ops = (old_whole, n_old) if who == "old" else (whole, len(captured) + 1)
            turns[who].append((graph_ms(fn, reps=1),
                               _profile_sums(_full_profile(fn, ops=ops, reps=3))[0]))
        row["in_turns"] = {k: {"graph_ms": [t for t, _ in v], "device_ms": [d for _, d in v]}
                           for k, v in turns.items()}
        log(f"{what}: {old_source}'s whole backward ({len(captured)} dense launches, then each "
            "level's bf16 add_, last iteration first) bit for bit the new accumulators; in turns "
            f"old, new, new, old per step: by CUDA graph old "
            f"{[round(t, 4) for t, _ in turns['old']]}, new "
            f"{[round(t, 4) for t, _ in turns['new']]} ms; on the device old "
            f"{[_fmt_ms(d) for _, d in turns['old']]}, new {[_fmt_ms(d) for _, d in turns['new']]}")
    return row, max_err


# the oracle-pose route with `pose.estimator=GT` (fault C.2): no flow, no
# pose estimate; PSNet's sweep once a pair (`_all_counters`' order)
GT_PER_PAIR = (0, SWEEP_PER_PAIR) + (0,) * 10


def phase_cli_gt(dev, sweep_warp, local_corr, raft_lookup):
    """`cli.main -v --override pose.estimator=GT use_gt_pose=True` on a
    golden KITTI raw tree rendered at 370x1224 (padded to 384x1280, bf16):
    SFMNet builds no pose net, runs no flow net and conditions PSNet on the
    ground-truth pose; the launch counts go to 0 before it, and each pair
    launches the sweep once and nothing else; the 9 Eigen metrics, finite.
    Returns the launches (`_all_counters`' order)."""
    from deep_sfm_revisited_tpu_torch import cli
    from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_raw_tree

    what = "cli GT pose"
    counters = _all_counters(sweep_warp, local_corr, raft_lookup)
    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti_raw"
        write_kitti_raw_tree(root, n_frames=PAIRS + 2, hw=(370, 1224), focal=K_KITTI[0][0],
                             n_test=PAIRS + 1)
        argv = ["--data", root, "--cfg", "kitti", "-v", "--gt-depth-dir", f"{root}/gt_depth",
                "--out", f"{tmp}/out", "--workers", "4", "--override", "pose.estimator=GT",
                "use_gt_pose=True"]
        log(f"{what}: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        results = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches(*counters)
    pairs = PAIRS + 1
    check(launches == tuple(pairs * n for n in GT_PER_PAIR), f"{what}: {pairs} pairs launched "
          f"{launches}, expected {GT_PER_PAIR} a pair")
    check(set(results) == EIGEN_KEYS, f"{what}: metrics {sorted(results)}")
    check(all(math.isfinite(v) for v in results.values()), f"{what}: metrics {results}")
    log(f"{what}: {pairs} pairs in {wall:.2f} s (cli.main), launches {launches}; metrics "
        f"{json.dumps(results)}")
    return launches


# ---------------------------------------------------------------------------
# Slice 17: PANet and REGNet through `cli -v`, REGNet's training step, and
# REGNet's sweep correlation K1 and its backward K2 (phases 29-33)

CORR_SOURCE = f"{PKG}/csrc/sweep_corr.cu"
CORR_FUSES = ("deep_sfm_revisited_tpu/models/depth_alternates.py:248 (REGNet's mean(ref * "
              "_scaled_sweep(tgt), -1) over its pose grid, :91-107)")
CORR_BWD_REPLACES = "deep_sfm_revisited_tpu/models/depth_alternates.py:248"
# K1 a channel of a valid sample: the blend, the product, the sum; K2: the
# blend, dref's product and sum, g ref, the four taps' products and sums
CORR_FLOPS_PER_CHANNEL = B1_FLOPS_PER_OUTPUT + 2
CORR_BWD_FLOPS_PER_CHANNEL = B1_FLOPS_PER_OUTPUT + 2 + 1 + 8
CORR_BWD_FLOPS_PER_SAMPLE = SWEEP_FLOPS_PER_SAMPLE + 4 + 1   # the tap weights, g / C
REGNET_TRAIN_STEPS = 3
# `_depth_counters`' order: B1's six, B2, its backward, the warped
# correlation, its backward, R1, R2, K1, K2
PANET_PER_PAIR = (0, SWEEP_PER_PAIR, 0, 0, DISP_PER_PAIR) + (0,) * 9
REGNET_PER_PAIR = (0, 0, 0, 0, DISP_PER_PAIR) + (0,) * 7 + (1, 0)
REGNET_PER_STEP = (0, 0, 0, 0, DISP_PER_PAIR) + (0,) * 7 + (1, 1)


def _depth_counters(sweep_warp, local_corr, raft_lookup, sweep_corr):
    return _all_counters(sweep_warp, local_corr, raft_lookup) + (
        sweep_corr.CORRELATION, sweep_corr.CORRELATION_BACKWARD)


def phase_small_depth_reference(dev, sweep_warp, sweep_corr) -> None:
    """PANet and REGNet on the card against the CPU: a 128x128 SFMNet in
    float32 (TF32 off) with `depth.estimator` PANET, then REGNET (DICL flow,
    the config's 9 scales and 5^3 poses, nlabel 8), same weights and inputs,
    conditioned on the same given pose, so the flow and RANSAC play no part;
    depth (and REGNet's depth_init) to 1e-3 relative, finite; PANet launches
    the sweep once, REGNet K1 once."""
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet

    g = torch.Generator().manual_seed(11)
    h = w = 128
    ref = torch.rand((1, h, w, 3), generator=g) * 2 - 1
    tgt = torch.roll(ref, (1, 3), dims=(1, 2)) + 0.05 * torch.randn((1, h, w, 3), generator=g)
    K = torch.tensor([[[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]]])
    a = 0.03
    pose_gt = torch.tensor([[[math.cos(a), 0, math.sin(a), 0.2], [0, 1, 0, 0.0],
                             [-math.sin(a), 0, math.cos(a), 0.95]]])
    for est, counter in (("PANET", sweep_warp.VOLUME), ("REGNET", sweep_corr.CORRELATION)):
        what = f"small reference {est}"
        cfg = SfMConfig.kitti().override(**SMALL, **{"depth.estimator": est})
        gpu = SFMNet(cfg, device=dev, seed=2)
        cpu = SFMNet(cfg, device="cpu", seed=2)
        before = counter.launches
        g_out = gpu(ref.to(dev), tgt.to(dev), K.to(dev), pose_gt=pose_gt.to(dev),
                    use_gt_pose=True)
        torch.cuda.synchronize()
        n = counter.launches - before
        c_out = cpu(ref, tgt, K, pose_gt=pose_gt, use_gt_pose=True)
        keys = ("depth",) if est == "PANET" else ("depth_init", "depth")
        check(est != "PANET" or g_out["depth_init"] is None, f"{what}: PANet gave a depth_init")
        errs = {}
        for k in keys:
            got = g_out[k].cpu()
            check(torch.isfinite(got).all(), f"{what}: non-finite {k}")
            errs[k] = float(((got - c_out[k]).abs() / c_out[k].abs()).max())
        log(f"{what}: depth relative |card - cpu| {json.dumps(errs)}; its kernel launched {n} "
            "time(s)")
        check(n == 1, f"{what}: its kernel launched {n} times, expected 1")
        check(all(v <= 1e-3 for v in errs.values()), f"{what}: depth differs by {errs}")


def phase_cli_depth(dev, est, counters, sweep_corr):
    """`cli.main -v --override depth.estimator=<est>` (PANET or REGNET) on
    a golden KITTI raw tree rendered at 370x1224 (padded to 384x1280, DICL
    flow, the 512x5 RANSAC, nlabel 128, bf16): PANet's 9 pose scales in one
    sweep, REGNet's 125 poses in one K1 launch. The warm-up pair records
    K1's inputs (REGNet); then each of the three test pairs must launch the
    displacement volume 5 times and the sweep once (PANet) or K1 once
    (REGNet) and nothing else; the 9 Eigen metrics, finite; ms per pair and
    the flow / pose / depth split by CUDA events; peak memory. Returns the
    launches over the test pairs (`_depth_counters`' order) and K1's inputs."""
    from deep_sfm_revisited_tpu_torch import cli
    from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_raw_tree
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet

    what = f"cli {est}"
    per_pair = PANET_PER_PAIR if est == "PANET" else REGNET_PER_PAIR
    rows, timer, cap = [], [], []
    real_forward, launch = SFMNet.forward, sweep_corr.sweep_correlation_cuda

    def record(*args):
        cap.append(tuple(a.clone() for a in args))
        return launch(*args)

    def timed_forward(model, *args, **kw):
        warm = not timer
        if warm:
            timer.append(StageTimer(model))
            sweep_corr.sweep_correlation_cuda = record
        before = _launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = real_forward(model, *args, **kw)
            torch.cuda.synchronize()
        finally:
            sweep_corr.sweep_correlation_cuda = launch
        ms = 1e3 * (time.perf_counter() - t0)
        n = tuple(a - b for a, b in zip(_launches(*counters), before))
        i = len(rows) + (0 if warm else 1)
        _check_pair(out, i)
        check(n == per_pair, f"{what} pair {i}: launches {n}, expected {per_pair}")
        if warm:
            for k in counters:
                k.launches = 0
            log(f"{what}: warm-up pair {ms:.1f} ms"
                + (f"; K1 inputs {[tuple(t.shape) for t in cap[0]]} {cap[0][0].dtype}"
                   if cap else ""))
        else:
            rows.append(dict(ms=ms, **timer[0].stages_ms()))
            r = rows[-1]
            log(f"{what}: pair {i}: {ms:.1f} ms (flow {r['flow']:.1f}, pose {r['pose']:.1f}, "
                f"depth {r['depth']:.1f} ms device); launches {n}")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti_raw"
        write_kitti_raw_tree(root, n_frames=PAIRS + 2, hw=(370, 1224), focal=K_KITTI[0][0],
                             n_test=PAIRS + 1)
        argv = ["--data", root, "--cfg", "kitti", "-v", "--gt-depth-dir", f"{root}/gt_depth",
                "--out", f"{tmp}/out", "--workers", "4", "--override",
                f"depth.estimator={est}", *[f"{k}={v}" for k, v in BENCH_OVERRIDES.items()]]
        log(f"{what}: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        torch.cuda.reset_peak_memory_stats()
        for k in counters:
            k.launches = 0
        SFMNet.forward = timed_forward
        try:
            t0 = time.perf_counter()
            results = cli.main(argv)
            wall = time.perf_counter() - t0
        finally:
            SFMNet.forward = real_forward
        launches = _launches(*counters)
    check(len(rows) == PAIRS, f"{what}: {len(rows)} test pairs after the warm-up")
    check(launches == tuple(PAIRS * n for n in per_pair), f"{what}: the test pairs launched "
          f"{launches}")
    # DICL's entropy sampler adds its `num_matches` and `uniform_fallback`
    check(EIGEN_KEYS <= set(results), f"{what}: metrics {sorted(results)}")
    check(all(math.isfinite(results[k]) for k in EIGEN_KEYS), f"{what}: metrics {results}")
    mean = {k: sum(r[k] for r in rows) / PAIRS for k in ("ms", "flow", "pose", "depth")}
    log(f"{what}: metrics {json.dumps(results)}")
    log(f"{what}: mean over {PAIRS} pairs: {mean['ms']:.2f} ms/pair; stages flow "
        f"{mean['flow']:.2f}, pose {mean['pose']:.2f}, depth {mean['depth']:.2f} ms; cli.main "
        f"{wall:.2f} s for {PAIRS + 1} pairs; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{what} rows: " + json.dumps(rows))
    return launches, cap


def phase_cli_train_regnet(dev, counters, sweep_corr):
    """REGNet's depth-training step through `cli.main` (no `-v`) with
    `depth.estimator=REGNET` on a rendered 370x1224 golden tree, the
    recipe's 256x768 crop, b = 4, bf16, DICL frozen, RANSAC: one warm-up
    step, which records K1's and K2's inputs and gradients, then
    REGNET_TRAIN_STEPS timed steps, each launching the displacement volume 5
    times, K1 and K2 once and nothing else, with a finite loss, DICL's
    parameters bit-identical and every REGNet parameter that got a gradient
    moved; the epoch's validation (9 finite Eigen metrics) and checkpoint;
    stage split by CUDA events, peak memory. Returns (the launches of the
    timed steps, K1's inputs, K2's inputs)."""
    from deep_sfm_revisited_tpu_torch import cli
    from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_raw_tree
    from deep_sfm_revisited_tpu_torch.train.trainer import Trainer

    what = "cli train REGNET"
    real_step = Trainer.train_step
    fwd, bwd = sweep_corr.sweep_correlation_cuda, sweep_corr.sweep_correlation_backward_cuda
    rows, cap1, cap2, timer = [], [], [], []
    steps = [(0,) * len(counters)]

    def record_fwd(*args):
        cap1.append(tuple(a.clone() for a in args))
        return fwd(*args)

    def record_bwd(*args):
        cap2.append(tuple(a.clone() for a in args))
        return bwd(*args)

    def timed_step(trainer, *args, **kw):
        warm = not timer
        if warm:
            timer.append(TrainStageTimer(trainer))
            sweep_corr.sweep_correlation_cuda = record_fwd
            sweep_corr.sweep_correlation_backward_cuda = record_bwd
        model = trainer.model
        dicl = {k: v.clone() for k, v in model.flow_estimator.state_dict().items()}
        params = {k: p.detach().clone() for k, p in model.depth_estimator.named_parameters()}
        before = _launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer[0]._mark("step_start")
        try:
            metrics = real_step(trainer, *args, **kw)
        finally:
            sweep_corr.sweep_correlation_cuda = fwd
            sweep_corr.sweep_correlation_backward_cuda = bwd
        timer[0]._mark("step_end")
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n = tuple(a - b for a, b in zip(_launches(*counters), before))
        i = len(rows) + (0 if warm else 1)
        loss = float(metrics["loss"])
        check(math.isfinite(loss), f"{what} step {i}: loss {loss}")
        check(n == REGNET_PER_STEP, f"{what} step {i}: launches {n}, expected {REGNET_PER_STEP}")
        for k, p in model.flow_estimator.named_parameters():
            check(torch.equal(p, dicl[k]), f"{what} step {i}: DICL parameter {k} moved")
        net = model.depth_estimator
        got_grad = [k for k, p in net.named_parameters() if p.grad is not None and p.grad.any()]
        still = [k for k in got_grad if torch.equal(dict(net.named_parameters())[k], params[k])]
        check(len(got_grad) > 0, f"{what} step {i}: no REGNet parameter got a gradient")
        check("feature_extraction.firstconv.0.0.weight" in got_grad,
              f"{what} step {i}: no gradient reached the feature net through K2")
        check(not still, f"{what} step {i}: REGNet parameters with a gradient did not move: "
              f"{still[:3]}")
        if warm:
            torch.cuda.reset_peak_memory_stats()
            log(f"{what}: warm-up step {ms:.1f} ms, loss {loss:.4f}; K1 inputs "
                f"{[tuple(t.shape) for t in cap1[0]]}, K2 gradient {tuple(cap2[0][0].shape)} "
                f"strides {cap2[0][0].stride()}")
        else:
            steps.append(n)
            rows.append(dict(ms=ms, loss=loss, **timer[0].stages_ms()))
            r = rows[-1]
            log(f"{what}: step {i}: {ms:.1f} ms (prep {r['prep']:.1f}, flow {r['flow']:.1f}, pose "
                f"{r['pose']:.1f}, depth forward {r['depth']:.1f}, loss + backward "
                f"{r['backward']:.1f}, Adam {r['adam']:.1f} ms device); loss {loss:.4f}; "
                f"launches {n}")
            if len(rows) == REGNET_TRAIN_STEPS:
                rows.append(dict(peak_gib=torch.cuda.max_memory_allocated() / 2**30))
        return metrics

    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti_raw"
        n_test = 2
        write_kitti_raw_tree(root, n_frames=n_test + TRAIN_B * (REGNET_TRAIN_STEPS + 1),
                             hw=(370, 1224), focal=K_KITTI[0][0], n_test=n_test)
        argv = ["--data", root, "--cfg", "kitti", "--gt-depth-dir", f"{root}/gt_depth",
                "--out", f"{tmp}/out", "--workers", "4", "-b", str(TRAIN_B), "--epochs", "1",
                "--override", f"data.train_size={TRAIN_HW}", "depth.estimator=REGNET",
                *[f"{k}={v}" for k, v in BENCH_OVERRIDES.items()]]
        log(f"{what}: cli.main(" + json.dumps(argv).replace(tmp, "<tmp>") + ")")
        for k in counters:
            k.launches = 0
        Trainer.train_step = timed_step
        try:
            t0 = time.perf_counter()
            history = cli.main(argv)
            wall = time.perf_counter() - t0
        finally:
            Trainer.train_step = real_step
        check(os.path.exists(f"{tmp}/out/kitti/ckpt/0.pt"), f"{what}: no checkpoint written")
    check(len(rows) == REGNET_TRAIN_STEPS + 1, f"{what}: {len(rows) - 1} timed steps")
    tail = rows.pop()
    check(len(history) == 1 and all(math.isfinite(history[0][k]) for k in EIGEN_KEYS),
          f"{what}: validation {history}")
    mean = {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}
    log(f"{what}: mean over {len(rows)} steps at b = {TRAIN_B}, {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
        f"{mean['ms']:.2f} ms/step; device stages prep {mean['prep']:.2f}, flow "
        f"{mean['flow']:.2f}, pose {mean['pose']:.2f}, depth forward {mean['depth']:.2f}, loss + "
        f"backward {mean['backward']:.2f}, Adam {mean['adam']:.2f} ms (step {mean['step']:.2f}); "
        f"peak memory {tail['peak_gib']:.2f} GiB; cli.main {wall:.2f} s; validation "
        f"{json.dumps({k: history[0][k] for k in sorted(EIGEN_KEYS)})}")
    log(f"{what} rows: " + json.dumps(rows))
    launches = tuple(sum(v) for v in zip(*steps))
    return launches, cap1[0], cap2[0]


def _corr_valid(depths, M, Kt, H, W, camera) -> int:
    """Samples (b, s, d, y, x) of a sweep correlation whose point lies in
    the frame (the ones the kernels blend), counted a pose at a time."""
    n = 0
    for s in range(M.shape[0]):
        x, y = camera.sweep_pixel_coords(depths, M[s:s + 1], Kt[s:s + 1], H, W)
        n += int(camera._taps(x.float(), y.float(), H, W)[0].sum())
    return n


def _corr_composition(ref, tgt, depths, M, Kt, g=None):
    """The composition K1 (with `g`: K1 and K2) replaced, one pose at a
    time: coordinates, `F.grid_sample` (align_corners, zeros) of the
    target, the product with ref, the channel mean; with `g`, its autograd
    with respect to ref and tgt. A yardstick the port never calls."""
    from deep_sfm_revisited_tpu_torch.ops import camera

    B, H, W, C = tgt.shape
    S, D = M.shape[0] // B, depths.shape[0]
    scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], device=tgt.device)
    with torch.set_grad_enabled(g is not None):
        nchw = tgt.permute(0, 3, 1, 2).float().requires_grad_(g is not None)
        r = ref.permute(0, 3, 1, 2).float()[:, :, None].requires_grad_(g is not None)
        for s in range(S):
            x, y = camera.sweep_pixel_coords(depths, M.view(B, S, 3, 3)[:, s],
                                             Kt.view(B, S, 3)[:, s], H, W)
            grid = torch.stack([x, y], -1).reshape(B, D * H, W, 2) * scale - 1
            warped = F.grid_sample(nchw, grid, align_corners=True).reshape(B, C, D, H, W)
            corr = (r * warped).mean(1)
            if g is not None:
                torch.autograd.grad(corr, (r, nchw), g[:, s])


def phase_sweep_corr(cap_eval, cap_train, cap_bwd, sweep_corr, camera):
    """K1 and K2 against their plain versions on the inputs phases 31 and 32
    recorded (K1: the REGNet eval pair's and the training step's, bf16,
    and the eval pair's in float32; K2: the training step's K1 inputs with
    the gradient autograd gave it): K1 bit for bit, two launches the same
    bits; K2's d ref and d tgt within 1e-5 of their largest element plus
    one bf16 ulp (`_grad_tol`), d ref the same bits every launch. Per eval
    pair (K1) and per training step (K2): device ms (torch.profiler; K2 with
    and without its zero fill and cast), CUDA-graph and events ms, the
    bound (bytes: each input read once, the output written once; float32
    operations of the valid samples), the plain version's ms, and no
    library call (no one PyTorch call computes either): the composition
    they replaced timed one pose at a time by events instead."""
    rows, errs = {}, {}
    what = "K1 (sweep correlation)"
    err = 0.0
    for name, args in (("eval pair", cap_eval), ("training step", cap_train),
                       ("eval pair, float32", (cap_eval[0].float(), cap_eval[1].float(),
                                               *cap_eval[2:]))):
        got = sweep_corr.sweep_correlation_cuda(*args)
        B = args[0].shape[0]
        want = camera.sweep_correlation_plain(*args[:3], args[3].view(B, -1, 3, 3),
                                              args[4].view(B, -1, 3))
        err = max(err, float((got - want).abs().max()))
        check(torch.equal(got, want), f"{what} {name}: differs from the plain version by {err}")
        check(torch.equal(got, sweep_corr.sweep_correlation_cuda(*args)),
              f"{what} {name}: two launches differ")
        del got, want
    errs["K1"] = err
    log(f"{what}: bit for bit the plain version on the eval pair's and the training step's "
        "inputs (bf16) and the eval pair's in float32; two launches the same bits")

    def k1_row(args, label):
        ref, tgt, depths, M, Kt = args
        B, H, W, C = ref.shape
        S, D = M.shape[0] // B, depths.shape[0]

        def run():
            sweep_corr.sweep_correlation_cuda(*args)

        def plain():
            camera.sweep_correlation_plain(ref, tgt, depths, M.view(B, S, 3, 3), Kt.view(B, S, 3))

        def comp():
            _corr_composition(ref, tgt, depths, M, Kt)

        ms, graph = cuda_ms(run, reps=5), graph_ms(run, reps=2)
        dev_ms = device_ms(run, "sweep_correlation_kernel", reps=5)
        plain_ms = cuda_ms(plain, reps=1, warmup=0)
        comp_ms = cuda_ms(comp, reps=1, warmup=1)
        valid = _corr_valid(depths, M, Kt, H, W, camera)
        samples = B * S * D * H * W
        nbytes = 2 * ref.numel() * ref.element_size() + 4 * (depths.numel() + M.numel()
                                                              + Kt.numel() + samples)
        flops = valid * (C * CORR_FLOPS_PER_CHANNEL + SWEEP_FLOPS_PER_SAMPLE) \
            + (samples - valid) * (SWEEP_FLOPS_PER_SAMPLE + 1)
        bound, bound_by = _bound_ms(nbytes, flops / F32_FLOPS * 1e3)
        log(f"{what} per {label} ({B} x {S} poses x {D} planes x {H}x{W}, C = {C} "
            f"{str(ref.dtype)[6:]}; {valid} of {samples} samples valid): device "
            f"{_fmt_ms(dev_ms)}, by CUDA graph {graph:.4f} ms, events {ms:.4f} ms; bound "
            f"{bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), share "
            f"{100 * bound / (dev_ms or graph):.1f}%; plain {plain_ms:.2f} ms; the composition "
            f"it replaced (grid_sample + product + mean, a pose at a time) {comp_ms:.2f} ms")
        return dict(ms=ms, device_ms=dev_ms, graph_ms=graph, plain_ms=plain_ms, bound_ms=bound,
                    bound_by=bound_by, library_ms=None, composition_ms=comp_ms, bytes=nbytes,
                    flops=flops, valid_samples=valid, samples=samples, shape=[B, S, D, H, W, C])

    rows["K1"] = k1_row(cap_eval, "eval pair")
    rows["K1"]["train_step"] = k1_row(cap_train, "training step")

    what = "K2 (sweep correlation backward)"
    g, ref, tgt, depths, M, Kt = cap_bwd
    B, H, W, C = ref.shape
    S, D = M.shape[0] // B, depths.shape[0]
    dref, dtgt = sweep_corr.sweep_correlation_backward_cuda(*cap_bwd)
    dref2, _ = sweep_corr.sweep_correlation_backward_cuda(*cap_bwd)
    check(torch.equal(dref, dref2), f"{what}: two launches' d ref differ")
    want = camera.sweep_correlation_backward_plain(g, ref, tgt, depths, M.view(B, S, 3, 3),
                                                   Kt.view(B, S, 3))
    err = 0.0
    for name, got, w in (("d ref", dref, want[0]), ("d tgt", dtgt, want[1])):
        diff = (got.float() - w.float()).abs()
        tol = _grad_tol(got, w)
        e = float(diff.max())
        err = max(err, e)
        log(f"{what} {name}: max |kernel - plain| {e:.3e}, max |plain| "
            f"{float(w.float().abs().max()):.3e}, {float((diff / tol).max()):.3f} of the tolerance")
        check(bool((diff <= tol).all()), f"{what} {name}: differs from the plain version")
    errs["K2"] = err
    del dref, dtgt, dref2, want

    def run():
        sweep_corr.sweep_correlation_backward_cuda(*cap_bwd)

    def plain():
        camera.sweep_correlation_backward_plain(g, ref, tgt, depths, M.view(B, S, 3, 3),
                                                Kt.view(B, S, 3))

    def comp():
        _corr_composition(ref, tgt, depths, M, Kt, g)

    ms, graph = cuda_ms(run, reps=2, warmup=1), graph_ms(run, reps=1)
    dev_ms = device_ms(run, "sweep_correlation_backward", reps=2)
    whole_ms, whole_ops = _profile_sums(_full_profile(run, reps=2))
    plain_ms = cuda_ms(plain, reps=1, warmup=0)
    comp_ms = cuda_ms(comp, reps=1, warmup=0)
    valid = _corr_valid(depths, M, Kt, H, W, camera)
    samples = B * S * D * H * W
    fbytes = ref.numel() * ref.element_size()
    nbytes = 4 * (samples + depths.numel() + M.numel() + Kt.numel()) + 4 * fbytes
    flops = valid * (C * CORR_BWD_FLOPS_PER_CHANNEL + CORR_BWD_FLOPS_PER_SAMPLE) \
        + (samples - valid) * SWEEP_FLOPS_PER_SAMPLE
    bound, bound_by = _bound_ms(nbytes, flops / F32_FLOPS * 1e3)
    log(f"{what} per training step ({B} x {S} poses x {D} planes x {H}x{W}, C = {C} "
        f"{str(ref.dtype)[6:]}; {valid} of {samples} samples valid): device {_fmt_ms(dev_ms)} "
        f"(with its zero fill and cast {_fmt_ms(whole_ms)}, {whole_ops} operations), by CUDA "
        f"graph {graph:.4f} ms, events {ms:.4f} ms; bound {bound:.4f} ms ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), share "
        f"{100 * bound / (dev_ms or graph):.1f}%; plain {plain_ms:.2f} ms; the composition it "
        f"replaced (grid_sample + product + mean and their autograd, a pose at a time) "
        f"{comp_ms:.2f} ms")
    rows["K2"] = dict(ms=ms, device_ms=dev_ms, whole_device_ms=whole_ms, graph_ms=graph,
                      plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=None,
                      composition_ms=comp_ms, bytes=nbytes, flops=flops, valid_samples=valid,
                      samples=samples, shape=[B, S, D, H, W, C])
    return rows, errs


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the port's smoke run on one CUDA device")
    ap.add_argument("--save-sweep-inputs", default=None,
                    help="write slice 5's sweep depths, M and K t to this .pt file")
    ap.add_argument("--save-disp-inputs", default=None,
                    help="write the displacement volume's inputs of slice 1's pair and of a "
                         "training step to this .pt file")
    ap.add_argument("--old-b1", default=None,
                    help="an earlier csrc/sweep_warp.cu whose sweep pose gradient phase 13, "
                         "whose displacement volume phase 14 (and, where it takes a hole "
                         "buffer, whose displacement backward phase 17) time in turns with "
                         "the current one")
    ap.add_argument("--old-b2", default=None,
                    help="an earlier csrc/local_corr.cu whose NHWC warped correlation, and the "
                         "span PWC-DC ran around it, phases 7 and 19 time in turns with the "
                         "current kernel and span")
    ap.add_argument("--old-b2-backward", default=None,
                    help="an earlier csrc/warped_corr_backward.cu (without mapping arguments) "
                         "whose backward kernels phase 22 times in turns with the current ones")
    ap.add_argument("--old-raft", default=None,
                    help="an earlier csrc/raft_lookup.cu (one block a query, R2 writing dense "
                         "level gradients) whose R1 phase 25 and whose whole backward, with "
                         "autograd's adds, phase 27 time in turns with the current ones")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    if not (REPO / PKG / "__init__.py").is_file():
        print(f"chip_smoke: the package {PKG} is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from deep_sfm_revisited_tpu_torch.models import dicl, pwcnet, raft
    from deep_sfm_revisited_tpu_torch.ops import camera, correlation
    from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr, raft_lookup, sweep_corr, sweep_warp

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_setup(sweep_warp, local_corr, raft_lookup, sweep_corr)
    cap_disp = {}
    with torch.no_grad():
        phase_pose(dev)
        phase_small_reference(dev, "DICL")
        phase_small_reference(dev, "PWC")
        sweep_dicl, disp_dicl, cap_sweep, cap_disp["dicl_main_path"] = phase_main_path(
            dev, sweep_warp)
        (b1_pwc, sweep_pwc, b2_pwc, disp_pwc, warped_pwc), (cap_w, cap_sweep_pwc, cap2) = \
            phase_cli_pwc(dev, sweep_warp, local_corr)
        cap1, cap2_all = pwc_warp_inputs(cap_w, cap2, sweep_warp)
        calls1, err1, gather_extras = phase_kernel(cap1, sweep_warp, camera)
        sweep_call, sweep_err = phase_sweep(cap_sweep + cap_sweep_pwc, sweep_warp, camera)
        calls2, err2 = phase_b2(cap2_all, local_corr, correlation)
        warped_call, warped_err = phase_warped("pwc_cli_eval", cap_w, local_corr, correlation,
                                               dicl, pwcnet, args.old_b2)
        warped_call["graph"] = warped_graph_check(cap_w, cap2[0], local_corr)
        del cap1, cap2_all, cap_w
    phase_small_train_reference(dev)
    phase_small_train_reference(dev, posenet=True)
    train_launches, cap_bwd, _, cap_disp["cli_train"] = phase_cli_train(dev, sweep_warp)
    check(train_launches[3] == 0,
          f"cli train: the RANSAC step launched the pose gradient {train_launches[3]} times")
    if args.save_sweep_inputs:
        _, depths, M, Kt = cap_bwd[0]
        torch.save({"depths": depths.cpu(), "M": M.cpu(), "Kt": Kt.cpu(),
                    "dvol_shape": list(cap_bwd[0][0].shape)}, args.save_sweep_inputs)
    with torch.no_grad():
        bwd_call, bwd_err = phase_sweep_backward(cap_bwd, sweep_warp, camera)
    del cap_bwd
    pose_paths, cap_disp["cli_record_pose"] = phase_cli_pose(dev, sweep_warp)
    pose_paths["cli_posenet_train"], _, cap_pose, _ = phase_cli_train(dev, sweep_warp,
                                                                      posenet=True)
    with torch.no_grad():
        pg_call, pg_err = phase_pose_grad(cap_pose, sweep_warp, camera, args.old_b1)
        del cap_pose
        if args.save_disp_inputs:
            torch.save({k: [tuple(t.cpu() if torch.is_tensor(t) else t for t in c)
                            for c in cap_disp[k][:DISP_PER_PAIR]]
                        for k in ("dicl_main_path", "cli_train")}, args.save_disp_inputs)
        disp_calls, disp_err = phase_displacement(cap_disp, sweep_warp, dicl, args.old_b1)
    del cap_disp
    # no path before slice 9 trains DICL: none launched the volume's backward
    check(sweep_warp.DISPLACEMENT_BACKWARD.launches == 0, "a frozen-flow path launched the "
          f"displacement volume's backward {sweep_warp.DISPLACEMENT_BACKWARD.launches} times")
    phase_small_flow_train_reference(dev)
    flow_launches, cap_flow = phase_cli_train_flow(dev, sweep_warp)
    with torch.no_grad():
        dbwd_call, dbwd_err = phase_displacement_backward(cap_flow, sweep_warp, dicl, args.old_b1)
    del cap_flow
    pwc_train, cap_w_train = phase_cli_train_pwc(dev, sweep_warp, local_corr)
    with torch.no_grad():
        warped_train, warped_train_err = phase_warped("cli_train_pwc", cap_w_train, local_corr,
                                                      correlation, dicl, pwcnet, args.old_b2)
    del cap_w_train
    # no path before slice 13 trains PWC-DC: none launched a correlation's backward
    check(local_corr.KERNEL_BACKWARD.launches == 0 and local_corr.WARPED_BACKWARD.launches == 0,
          "a path that does not train PWC-DC launched a correlation backward: B2's "
          f"{local_corr.KERNEL_BACKWARD.launches}, the warped one's "
          f"{local_corr.WARPED_BACKWARD.launches} times")
    phase_small_pwc_flow_train_reference(dev, local_corr)
    pwc_flow, cap_corr = phase_cli_train_flow_pwc(dev, sweep_warp, local_corr)
    with torch.no_grad():
        corr_bwd, corr_bwd_err = phase_corr_backward(cap_corr, local_corr, correlation,
                                                     args.old_b2_backward)
    del cap_corr
    # no path before slice 15 runs RAFT
    check(raft_lookup.LOOKUP.launches == 0 and raft_lookup.LOOKUP_BACKWARD.launches == 0,
          f"a path without RAFT launched R1 {raft_lookup.LOOKUP.launches} and R2 "
          f"{raft_lookup.LOOKUP_BACKWARD.launches} times")
    t_raft = time.perf_counter()
    phase_small_raft_reference(dev, raft_lookup)
    with torch.no_grad():
        raft_eval, cap_raft = phase_cli_raft(dev, sweep_warp, local_corr, raft_lookup)
        r1_call, r1_err = phase_raft_lookup(cap_raft, raft_lookup, raft, args.old_raft)
    del cap_raft
    # the eval path does not train RAFT: no R2
    check(raft_lookup.LOOKUP_BACKWARD.launches == 0, "the RAFT eval path launched R2 "
          f"{raft_lookup.LOOKUP_BACKWARD.launches} times")
    raft_flow, cap_r2 = phase_cli_train_flow_raft(dev, sweep_warp, local_corr, raft_lookup)
    with torch.no_grad():
        r2_call, r2_err = phase_raft_backward(cap_r2, raft_lookup, raft, args.old_raft)
    del cap_r2
    log(f"chip_smoke: the RAFT phases 23-27 took {time.perf_counter() - t_raft:.1f} s")
    with torch.no_grad():
        gt_eval = phase_cli_gt(dev, sweep_warp, local_corr, raft_lookup)
    # no path before slice 17 runs REGNet
    check(sweep_corr.CORRELATION.launches == 0 and sweep_corr.CORRELATION_BACKWARD.launches == 0,
          f"a path without REGNet launched K1 {sweep_corr.CORRELATION.launches} and K2 "
          f"{sweep_corr.CORRELATION_BACKWARD.launches} times")
    t_depth = time.perf_counter()
    depth_counters = _depth_counters(sweep_warp, local_corr, raft_lookup, sweep_corr)
    with torch.no_grad():
        phase_small_depth_reference(dev, sweep_warp, sweep_corr)
        panet_eval, _ = phase_cli_depth(dev, "PANET", depth_counters, sweep_corr)
        regnet_eval, cap_k1 = phase_cli_depth(dev, "REGNET", depth_counters, sweep_corr)
    regnet_train, cap_k1_train, cap_k2 = phase_cli_train_regnet(dev, depth_counters, sweep_corr)
    with torch.no_grad():
        corr_rows, corr_err = phase_sweep_corr(cap_k1[0], cap_k1_train, cap_k2, sweep_corr,
                                               camera)
    del cap_k1, cap_k1_train, cap_k2
    log(f"chip_smoke: the PANet and REGNet phases 29-33 took {time.perf_counter() - t_depth:.1f} s")
    names = ("gather", "sweep", "backward", "pose_grad", "volume", "volume_backward", "warped",
             "b2", "b2_backward", "warped_backward", "raft_lookup", "raft_lookup_backward",
             "sweep_correlation", "sweep_correlation_backward")

    def path(v):
        return dict(zip(names, tuple(v) + (0,) * (len(names) - len(v))))

    by_path = {"dicl_main_path": path((0, sweep_dicl, 0, 0, disp_dicl)),
               "pwc_cli_eval": path((b1_pwc, sweep_pwc, 0, 0, disp_pwc, 0, warped_pwc, b2_pwc)),
               "cli_train": path(train_launches),
               **{k: path(v) for k, v in pose_paths.items()},
               "cli_train_flow": path(flow_launches),
               "cli_train_pwc": path(pwc_train),
               # B1's six kernels, then B2, its backward, the warped correlation, its backward
               "cli_train_flow_pwc": path(pwc_flow[:6] + (pwc_flow[8], pwc_flow[6], pwc_flow[7],
                                                          pwc_flow[9])),
               # `_all_counters`' order: B1's six, B2, its backward, the warped
               # correlation, its backward, R1, R2
               **{k: path(v[:6] + (v[8], v[6], v[7], v[9], v[10], v[11]))
                  for k, v in (("cli_eval_raft", raft_eval), ("cli_train_flow_raft", raft_flow),
                               ("cli_eval_gt", gt_eval))},
               # `_depth_counters`' order: `_all_counters`' then K1, K2
               **{k: path(v[:6] + (v[8], v[6], v[7], v[9], v[10], v[11], v[12], v[13]))
                  for k, v in (("cli_eval_panet", panet_eval), ("cli_eval_regnet", regnet_eval),
                               ("cli_train_regnet", regnet_train))}}

    def launches(kernel):
        counts = {k: v[kernel] for k, v in by_path.items()}
        return {"launches": sum(counts.values()), "launches_by_path": counts}

    # on no main path: PWC-DC's four flow warps are fused into the warped
    # correlation, DICL's into its displacement volume; its times are per
    # PWC-DC pair, on the warps the warped correlation computes
    b1 = {"name": "bilinear_sample", "route": "cuda", "source": B1_SOURCE,
          "replaces": B1_REPLACES, **launches("gather"), "max_abs_err": err1,
          **_pair_sums(calls1), **gather_extras, "calls": calls1}
    # per slice-1 pair: DICL's five levels, each one launch (the training
    # step's five beside it); no single PyTorch call builds the stack, so
    # there is no library time (the composition it replaced is timed beside
    # it)
    disp = {"name": "displacement_volume", "route": "cuda", "source": B1_SOURCE,
            "replaces": B1_REPLACES, "fuses": DISP_FUSES, **launches("volume"),
            "max_abs_err": disp_err,
            **{k: v for k, v in disp_calls["dicl_main_path"].items() if k != "calls"},
            "train_step": disp_calls["cli_train"],
            "calls": disp_calls["dicl_main_path"]["calls"]}
    # one launch per pair on either slice; no single PyTorch call builds the
    # volume, so there is no library time (the composition it replaced is
    # timed beside it)
    sweep = {"name": "plane_sweep_volume", "route": "cuda", "source": B1_SOURCE,
             "replaces": B1_REPLACES, **launches("sweep"), "max_abs_err": sweep_err,
             **{k: v for k, v in sweep_call.items() if k != "name"}}
    b2 = {"name": "local_correlation", "route": "cuda", "source": B2_SOURCE,
          "replaces": B2_REPLACES, **launches("b2"), "max_abs_err": err2,
          # per frame pair: PWC-DC's five levels; no single PyTorch call
          # computes a windowed correlation, so there is no library time
          **_pair_sums(calls2), "calls": calls2}
    # one launch per training step; it replaces the gradient XLA derives for
    # the JAX cost volume (the TPU had no kernel of its own for it)
    bwd = {"name": "plane_sweep_volume_backward", "route": "cuda", "source": B1_SOURCE,
           "replaces": BWD_REPLACES, **launches("backward"), "max_abs_err": bwd_err,
           **{k: v for k, v in bwd_call.items() if k != "name"}}
    # one launch per POSENET training step, none on the RANSAC step (its pose
    # is stop-gradient); it replaces the gradient XLA derives for the JAX cost
    # volume with respect to the pose
    pg = {"name": "plane_sweep_volume_pose_grad", "route": "cuda", "source": B1_SOURCE,
          "replaces": POSE_GRAD_REPLACES, **launches("pose_grad"), "max_abs_err": pg_err,
          **{k: v for k, v in pg_call.items() if k != "name"}}
    # five launches per flow-training step (DICL's levels, largest first);
    # it replaces the gradient XLA derives for the JAX stack, and no single
    # PyTorch call computes it (the eager composition's autograd and
    # grid_sampler_2d_backward are timed beside it)
    dbwd = {"name": "displacement_volume_backward", "route": "cuda", "source": B1_SOURCE,
            "replaces": DISP_BWD_REPLACES, "gradient_of": DISP_FUSES,
            **launches("volume_backward"), "max_abs_err": dbwd_err,
            **{k: v for k, v in dbwd_call.items() if k != "calls"}, "calls": dbwd_call["calls"]}
    # per frame pair: PWC-DC's levels 5..2, one launch each (the training
    # step's four beside it); no single PyTorch call warps and correlates, so
    # there is no library time (PWC-DC's span is timed beside it)
    warped = {"name": "warped_correlation", "route": "cuda", "source": WARPED_SOURCE,
              "replaces": B2_REPLACES, "fuses": WARPED_FUSES, **launches("warped"),
              "max_abs_err": max(warped_err, warped_train_err), **warped_call,
              "train_step": warped_train}
    # once a PWC-DC flow-training step (level 6); it replaces the gradient
    # XLA derives for the JAX correlation, and no single PyTorch call
    # computes it (autograd of the eager composition is timed beside it)
    b2_bwd = {"name": "local_correlation_backward", "route": "cuda", "source": CORR_BWD_SOURCE,
              "replaces": B2_BWD_REPLACES, "gradient_of": B2_REPLACES,
              **launches("b2_backward"), "max_abs_err": corr_bwd_err["b2"],
              **{k: v for k, v in corr_bwd["b2"].items() if k != "calls"},
              "calls": corr_bwd["b2"]["calls"]}
    # four times a PWC-DC flow-training step (levels 5..2); it replaces the
    # gradient XLA derives for the JAX warp and correlation; no single
    # PyTorch call computes it (autograd of the eager composition, and
    # grid_sampler_2d_backward for the warp's half, are timed beside it)
    warped_bwd = {"name": "warped_correlation_backward", "route": "cuda",
                  "source": CORR_BWD_SOURCE, "replaces": WARPED_BWD_REPLACES,
                  "gradient_of": WARPED_FUSES, **launches("warped_backward"),
                  "max_abs_err": corr_bwd_err["warped"],
                  **{k: v for k, v in corr_bwd["warped"].items() if k != "calls"},
                  "calls": corr_bwd["warped"]["calls"]}
    # 24 launches an eval pair (one an iteration, all four levels), 12 a
    # RAFT flow-training step and 24 a validation pair; no TPU kernel behind
    # it (XLA one-hot matmuls); `F.grid_sample` over the four levels is
    # upstream RAFT's lookup, timed as the yardstick
    r1 = {"name": "raft_lookup", "route": "cuda", "source": RAFT_SOURCE,
          "replaces": RAFT_REPLACES, **launches("raft_lookup"), "max_abs_err": r1_err, **r1_call}
    # 12 launches a RAFT flow-training step; `grid_sampler_2d_backward` over
    # the four levels (input and grid gradients) is upstream's gradient
    r2 = {"name": "raft_lookup_backward", "route": "cuda", "source": RAFT_SOURCE,
          "replaces": RAFT_REPLACES, "gradient_of": RAFT_REPLACES,
          **launches("raft_lookup_backward"), "max_abs_err": r2_err, **r2_call}
    # one launch a REGNet eval pair (all 125 poses) and a training step, no
    # TPU kernel of its own behind it (XLA's gather under plane_sweep_warp,
    # then the mean); no one PyTorch call computes it: the composition it
    # replaced is timed a pose at a time beside it
    k1 = {"name": "sweep_correlation", "route": "cuda", "source": CORR_SOURCE,
          "replaces": B1_REPLACES, "fuses": CORR_FUSES, **launches("sweep_correlation"),
          "max_abs_err": corr_err["K1"], **corr_rows["K1"]}
    # one launch a REGNet training step; it replaces the gradient XLA derives
    # for the JAX correlation
    k2 = {"name": "sweep_correlation_backward", "route": "cuda", "source": CORR_SOURCE,
          "replaces": CORR_BWD_REPLACES, "gradient_of": CORR_FUSES,
          **launches("sweep_correlation_backward"), "max_abs_err": corr_err["K2"],
          **corr_rows["K2"]}
    kernels = [b1, disp, sweep, b2, bwd, pg, dbwd, warped, b2_bwd, warped_bwd, r1, r2, k1, k2]
    check(b1["launches"] == 0, f"a main path launched the standalone gather {b1['launches']} "
          "times")
    check(all(k["launches"] > 0 for k in kernels if k is not b1), "a kernel was launched no "
          f"time on the main paths: {[(k['name'], k['launches']) for k in kernels]}")
    check(pg["launches_by_path"]["cli_posenet_train"] > 0
          and disp["launches_by_path"]["cli_record_pose"] > 0,
          "the pose paths launched no pose gradient or no displacement volume")
    check(dbwd["launches_by_path"]["cli_train_flow"] > 0
          and disp["launches_by_path"]["cli_train_flow"] > 0,
          "the flow-training path launched no displacement volume or no backward")
    check(b2["launches_by_path"]["cli_train_pwc"] > 0
          and warped["launches_by_path"]["cli_train_pwc"] > 0,
          "the PWC-DC training path launched no B2 or no warped correlation")
    check(all(k["launches_by_path"]["cli_train_flow_pwc"] > 0
              for k in (b2, warped, b2_bwd, warped_bwd)),
          "PWC-DC's flow-training path launched no B2, warped correlation or backward")
    check(r1["launches_by_path"]["cli_eval_raft"] > 0
          and r1["launches_by_path"]["cli_train_flow_raft"] > 0
          and r2["launches_by_path"]["cli_train_flow_raft"] > 0,
          "RAFT's paths launched no R1 or no R2")
    check(sweep["launches_by_path"]["cli_eval_gt"] > 0, "the GT-pose path launched no sweep")
    check(sweep["launches_by_path"]["cli_eval_panet"] > 0, "the PANet path launched no sweep")
    check(k1["launches_by_path"]["cli_eval_regnet"] > 0
          and k1["launches_by_path"]["cli_train_regnet"] > 0
          and k2["launches_by_path"]["cli_train_regnet"] > 0,
          "REGNet's paths launched no K1 or no K2")
    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        dev = "not measured" if k["device_ms"] is None else f"{k['device_ms']:.4f} ms"
        log(f"{k['name']} per pair or step: kernel {k['ms']:.4f} ms (device {dev}), plain "
            f"{k['plain_ms']:.4f} ms, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), library {lib}, "
            f"launches {k['launches']}")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
