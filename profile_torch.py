#!/usr/bin/env python3
"""Where one frame pair's time goes on the GPU: the port's main path under torch.profiler.

    python3 profile_torch.py [--flow PWC|RAFT] [--out profile_torch_out]   # needs one CUDA device

Builds the main path exactly as `chip_smoke.py` does (SFMNet eval under the
KITTI recipe with bench.py's overrides, 384x1280, b=1, nlabel 128, bf16
autocast, random weights from a seed; DICL flow, or with `--flow PWC`
PWC-DC's, as slice 2 runs it, or with `--flow RAFT` RAFT's, 24 iterations,
as `cli -v` runs it), runs two warm-up pairs, then profiles one
more pair with CPU and CUDA activities, stage by stage: the flow, the pose
(sampler + RANSAC) and PSNet depth, as `SFMNet.forward` runs them, with a
synchronize closing each stage so that every kernel of a stage ends inside
the stage's host span. For each stage it prints the host span, the
device's busy time (the summed device time of the kernels, copies and
fills in the span; one stream, so they do not overlap), the idle share and
the number of kernels; per stage, the device time and count of the kernel
groups that the cost volume's layout moves (cuDNN's NCHW<->NHWC layout
transposes, BatchNorm, B1's sweep, gather and displacement-volume kernels,
B2 and the warped correlation, RAFT's lookup R1, the GEMM kernels of
products and convolutions, copies and casts); the peak device memory
of the profiled pair; then the kernels that take most device time, over
the pair and in the depth stage. Writes
one JSON summary and the Chrome trace into --out.

It runs against whatever package sits beside it, so a copy of this script
placed in an earlier tree of the repository profiles that tree the same way.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

import chip_smoke as smoke

# kernel groups by (lower-case) name fragment
GROUPS = {"layout_transpose": ("nchwtonhwc", "nhwctonchw"),
          "batch_norm": ("batch_norm", "bn_fw", "bn_bw"),
          "sweep_kernel": ("plane_sweep_volume_kernel",),
          "gather_kernel": ("bilinear_sample_kernel",),
          "displacement_volume_kernel": ("displacement_volume_kernel",
                                         "displacement_volume_sample"),
          "b2_kernel": ("local_corr_kernel",),
          "warped_correlation_kernel": ("warped_corr_kernel",),
          "raft_lookup_kernel": ("raft_lookup_kernel",),
          "matmul_or_conv": ("gemm", "cutlass"),
          "copy_or_cast": ("direct_copy_kernel",)}


def _groups(events):
    out = {}
    for group, keys in GROUPS.items():
        hits = [e for e in events if any(k in e.name.lower() for k in keys)]
        out[group] = dict(ms=sum(e.time_range.elapsed_us() for e in hits) / 1e3,
                          count=len(hits))
    return out


def _top(events, n):
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    return sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_torch_out")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--flow", choices=("DICL", "PWC", "RAFT"), default="DICL",
                    help="the flow estimator (slice 1: DICL, slice 2: PWC, slice 15: RAFT)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    from deep_sfm_revisited_tpu_torch.config import SfMConfig
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
    from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr, raft_lookup, sweep_warp

    # card line, TF32 off, B1, B2 and R1/R2 built
    card = smoke.phase_setup(sweep_warp, local_corr, raft_lookup)
    dev = torch.device("cuda", 0)
    cfg = SfMConfig.kitti(nlabel=128).override(**smoke.BENCH_OVERRIDES,
                                               **{"flow.estimator": args.flow})
    model = SFMNet(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(4)
    refs = torch.rand((3, smoke.B, smoke.H, smoke.W, 3), generator=g, device=dev) * 2 - 1
    tgts = torch.roll(refs, 3, dims=3)
    K = torch.tensor(smoke.K_KITTI, device=dev).expand(smoke.B, 3, 3)

    def pair(ref, tgt, seed):
        """SFMNet.forward's online route, one stage at a time."""
        spans = {}
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name in ("flow", "pose", "depth"):
            with record_function(f"stage:{name}"):
                t0 = time.perf_counter()
                if name == "flow":
                    K_inv = torch.linalg.inv(K)
                    with model._autocast():
                        flow, conf = model.flow_estimator(torch.cat([ref, tgt], dim=-1))
                elif name == "pose":
                    pose = model._pose_by_ransac(flow.float(), K_inv, conf, gen, {})[0]
                else:
                    with model._autocast():
                        depth = model.depth_estimator(ref, tgt[:, None], pose[:, None], K, K_inv)[1]
                torch.cuda.synchronize()
                spans[name] = 1e3 * (time.perf_counter() - t0)
        smoke._check_pair({"depth": depth, "pose": pose}, seed)
        return spans

    with torch.no_grad():
        for i in range(2):
            pair(refs[i], tgts[i], 100 + i)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            host = pair(refs[2], tgts[2], 102)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the stage ranges as the host saw them; on the device timeline they
    # reappear as annotations, which are not device work
    stages = {e.name[len("stage:"):]: e.time_range for e in events
              if e.name.startswith("stage:") and e.device_type != cuda}
    device = [e for e in events if e.device_type == cuda and not e.name.startswith("stage:")]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    per_stage = {}
    for name, span in stages.items():
        inside = [e for e in device if span.start <= e.time_range.start < span.end]
        busy_us = sum(e.time_range.elapsed_us() for e in inside)
        per_stage[name] = dict(host_ms=host[name], span_ms=span.elapsed_us() / 1e3,
                               busy_ms=busy_us / 1e3,
                               idle_share=1.0 - busy_us / span.elapsed_us(),
                               kernels=len(inside), groups=_groups(inside))
        if name == "depth":
            depth_top = _top(inside, args.top)
    top = _top(device, args.top)
    total_busy = sum(s["busy_ms"] for s in per_stage.values())
    total_span = sum(s["span_ms"] for s in per_stage.values())

    for name, s in per_stage.items():
        groups = ", ".join(f"{g} {v['ms']:.3f} ms in {v['count']}"
                           for g, v in s["groups"].items() if v["count"])
        print(f"{name}: span {s['span_ms']:.2f} ms, device busy {s['busy_ms']:.2f} ms, "
              f"idle {100 * s['idle_share']:.1f}%, {s['kernels']} kernels; {groups}", flush=True)
    print(f"pair: span {total_span:.2f} ms, device busy {total_busy:.2f} ms, idle "
          f"{100 * (1 - total_busy / total_span):.1f}%, {len(device)} kernels; peak device "
          f"memory {peak_gib:.3f} GiB")
    for title, rows in (("pair", top), ("depth stage", depth_top)):
        print(f"top kernels, {title}:")
        for name, (ms, n) in rows:
            print(f"  {ms:9.3f} ms  {n:5d}x  {name[:110]}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    summary = {"card": card, "flow": args.flow, "stages": per_stage, "pair_span_ms": total_span,
               "pair_busy_ms": total_busy, "kernels": len(device), "peak_gib": peak_gib,
               "top": [{"name": n, "ms": ms, "count": c} for n, (ms, c) in top],
               "depth_top": [{"name": n, "ms": ms, "count": c} for n, (ms, c) in depth_top]}
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    prof.export_chrome_trace(str(out / "trace.json"))
    print(json.dumps(summary["stages"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
