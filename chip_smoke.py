#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deep_sfm_revisited_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA device

Phases, each of which raises on failure:

1. setup: the card's name and power limit, TF32 off, kernel B1 built with
   nvcc from `deep_sfm_revisited_tpu_torch/csrc/sweep_warp.cu`;
2. pose on the card: rigid flow of a known (R, t) -> correspondence
   sampler -> five-point RANSAC in float64 recovers the pose, the
   zero-parallax probe gives a finite pose, and with noise and outliers
   added the card's RANSAC equals the CPU's on the same samples;
3. small-input reference: a 128x128 SFMNet in float32 on the card against
   the same weights and random draws on the CPU, where the port runs its
   plain versions (the CPU tests hold those against the JAX package);
4. the main path: SFMNet eval under the KITTI recipe (DICL flow -> entropy
   sampler -> 512x5-hypothesis five-point RANSAC in float64 -> PSNet with
   128 planes) at 384x1280, b=1, bf16 autocast, random weights from a
   seed, as `bench.py` runs the JAX package. One warm-up pair records B1's
   inputs; then the launch counts go to 0, three distinct pairs run, and
   each must have launched B1 five times (PSNet's plane sweep and DICL's
   flow warps at levels 5..2);
5. B1 against its plain PyTorch version on the inputs the main path gave
   it, with out-of-range and behind-the-camera coordinates added, in bf16
   and float32; its time beside the plain version's, `F.grid_sample`'s
   and the bound.

The line before the last is the kernel table as one JSON object; the last
is {"ok": true, "device": {...}}. Without a CUDA device, or without the
port's package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
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
B1_PER_PAIR = 5  # PSNet's plane sweep + DICL's warp_flow at levels 5, 4, 3, 2

# the small-input reference: two-stage vote on, float64 candidates so the
# vote is reproducible across devices
SMALL = {"depth.nlabel": 8, "pose.num_hypotheses": 16, "pose.ransac_iter": 1,
         "pose.num_correspondences": 128, "pose.score_subset": 32,
         "pose.score_topk": 64, "pose.polish_iters": 5, "pose.solve_dtype": "float64"}

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
B1_FLOPS_PER_OUTPUT = 10  # 6 tap products, 3 sums, the validity product

B1_SOURCE = f"{PKG}/csrc/sweep_warp.cu"
B1_REPLACES = "deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py:145"


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


def phase_setup(sweep_warp) -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"setup: torch {torch.__version__} cuda {torch.version.cuda}; "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    sweep_warp.KERNEL.build()
    log(f"setup: B1 built in {time.perf_counter() - t0:.2f} s")
    for line in sweep_warp.KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
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


def phase_small_reference(dev) -> None:
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

    cfg = SfMConfig.kitti().override(**SMALL)
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
    n_cand = cfg.pose.num_correspondences * 4
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
    log(f"small reference: flow max |card - cpu| {flow_err:.3e} px; confident "
        f"candidates {int(g_on['num_matches'][0])} vs {int(c_on['num_matches'][0])}; "
        f"inliers {n_in[0]} vs {n_in[1]}; pose max |card - cpu| {pose_err:.3e}; depth "
        f"relative {d_on:.3e} (card's pose), {d_gt:.3e} (given pose)")
    check(flow_err <= 1e-3, f"small reference: flow differs by {flow_err} px")
    check(torch.equal(g_on["num_matches"], c_on["num_matches"]),
          "small reference: confident-candidate counts differ")
    _check_pose(g_on["pose"], "small reference")
    check(d_on <= 1e-3, f"small reference: depth at the card's pose differs by {d_on}")
    check(d_gt <= 1e-3, f"small reference: depth at the given pose differs by {d_gt}")


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


def phase_main_path(dev, sweep_warp):
    """Warm-up pair (records B1's inputs), then PAIRS counted, timed pairs."""
    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet

    cfg = SfMConfig.kitti(nlabel=128).override(**BENCH_OVERRIDES)
    model = SFMNet(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(4)
    refs = torch.rand((PAIRS + 1, B, H, W, 3), generator=g, device=dev) * 2 - 1
    tgts = torch.roll(refs, 3, dims=3)          # bench.py's target
    K = torch.tensor(K_KITTI, device=dev).expand(B, 3, 3)
    timer = StageTimer(model)

    captured = []
    launch = sweep_warp.bilinear_sample_cuda

    def recording(img, coords):
        captured.append((img.clone(), coords.clone()))
        return launch(img, coords)

    sweep_warp.bilinear_sample_cuda = recording
    try:
        t0 = time.perf_counter()
        _check_pair(model(refs[0], tgts[0], K,
                          generator=torch.Generator(device=dev).manual_seed(100)), 0)
        torch.cuda.synchronize()
    finally:
        sweep_warp.bilinear_sample_cuda = launch
    log(f"main path: warm-up pair {1e3 * (time.perf_counter() - t0):.1f} ms, "
        f"B1 inputs recorded: {[tuple(c.shape) for _, c in captured]}")
    check(len(captured) == B1_PER_PAIR, f"warm-up launched B1 {len(captured)} times")

    torch.cuda.reset_peak_memory_stats()
    sweep_warp.KERNEL.launches = 0
    rows = []
    for i in range(1, PAIRS + 1):
        before = sweep_warp.KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(refs[i], tgts[i], K,
                    generator=torch.Generator(device=dev).manual_seed(100 + i))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n = sweep_warp.KERNEL.launches - before
        _check_pair(out, i)
        check(n == B1_PER_PAIR, f"pair {i}: B1 launched {n} times, expected {B1_PER_PAIR}")
        rows.append(dict(ms=ms, **timer.stages_ms(), inliers=int(out["inliers"][0]),
                         num_matches=int(out["num_matches"][0])))
        log(f"main path: pair {i}: {ms:.1f} ms (flow {rows[-1]['flow']:.1f}, pose "
            f"{rows[-1]['pose']:.1f}, depth {rows[-1]['depth']:.1f} ms device); "
            f"inliers {rows[-1]['inliers']}/{cfg.pose.num_correspondences}, confident candidates "
            f"{rows[-1]['num_matches']}, B1 launches {n}")
    launches = sweep_warp.KERNEL.launches
    check(launches == B1_PER_PAIR * PAIRS, f"B1 launched {launches} times in the main path")
    mean = {k: sum(r[k] for r in rows) / PAIRS for k in ("ms", "flow", "pose", "depth")}
    log(f"main path: mean over {PAIRS} pairs: {mean['ms']:.2f} ms/pair "
        f"({1e3 / mean['ms']:.3f} pairs/s); stages flow {mean['flow']:.2f}, pose "
        f"{mean['pose']:.2f}, depth {mean['depth']:.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("main path rows: " + json.dumps(rows))
    return launches, captured


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


def phase_kernel(captured, sweep_warp, camera):
    """B1 vs its plain version at the main path's inputs; times and bounds.

    Tolerance: exact in bf16 and float32 -- the kernel rounds op by op with
    __fmul_rn/__fadd_rn in the plain version's order (the card's own bound
    would be 1e-6 in float32 and one bf16 ulp)."""
    calls, max_err = [], 0.0
    for img, coords in captured:
        _, h, w, _ = img.shape
        name = "psnet_sweep" if coords.dim() == 5 else f"dicl_warp_{h}x{w}"
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
        plain_ms = cuda_ms(lambda: camera.bilinear_sample_plain(img, coords), reps=3, warmup=1)
        library_ms = cuda_ms(lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                                    padding_mode="zeros",
                                                    align_corners=True), reps=20)
        nbytes = (img.numel() * img.element_size() + coords.numel() * coords.element_size()
                  + out.numel() * out.element_size())
        flops = B1_FLOPS_PER_OUTPUT * out.numel()
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        calls.append(dict(name=name, img=list(img.shape), coords=list(coords.shape),
                          dtype=str(img.dtype).replace("torch.", ""),
                          out_of_range=float(invalid), ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else "operations",
                          bytes=nbytes, flops=flops))
        log(f"B1 {name}: img {tuple(img.shape)} coords {tuple(coords.shape)} "
            f"{calls[-1]['dtype']}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"grid_sample {library_ms:.4f} ms, bound {calls[-1]['bound_ms']:.4f} ms "
            f"({calls[-1]['bound_by']}, {nbytes / 1e6:.1f} MB); "
            f"{100 * float(invalid):.1f}% of queries out of range")
    return calls, max_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    if not (REPO / PKG / "__init__.py").is_file():
        print(f"chip_smoke: the package {PKG} is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from deep_sfm_revisited_tpu_torch.ops import camera
    from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_setup(sweep_warp)
    with torch.no_grad():
        phase_pose(dev)
        phase_small_reference(dev)
        launches, captured = phase_main_path(dev, sweep_warp)
        calls, max_err = phase_kernel(captured, sweep_warp, camera)

    t_bytes = sum(c["bytes"] for c in calls) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(c["flops"] for c in calls) / F32_FLOPS * 1e3
    b1 = {"name": "bilinear_sample", "route": "cuda", "source": B1_SOURCE,
          "replaces": B1_REPLACES, "launches": launches, "max_abs_err": max_err,
          # times and bound per frame pair: the five calls the main path makes
          "ms": sum(c["ms"] for c in calls),
          "plain_ms": sum(c["plain_ms"] for c in calls),
          "bound_ms": max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
          "library_ms": sum(c["library_ms"] for c in calls),
          "calls": calls}
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [b1]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
