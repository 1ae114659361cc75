#!/usr/bin/env python3
"""Kernel B2 against an earlier source of itself, in turns, on one card; and
every work mapping of the current source, to check `plan`'s choice.

    git show <commit>:deep_sfm_revisited_tpu_torch/csrc/local_corr.cu > local/local_corr_old.cu
    python3 b2_compare.py --old local/local_corr_old.cu   # needs one CUDA device
    python3 b2_compare.py --sweep [--variant other.cu ...]
    python3 b2_compare.py --warped-plans
    python3 b2_compare.py --backward-plans [--old-backward local/warped_corr_backward_old.cu]

Builds the older source (its C entry point without the mapping arguments:
`dsfm_local_correlation(f0, f1, out, B, H, W, C, md, stream)`) beside the
current one, and at PWC-DC's five level shapes (f0, f1 float32 of a
384x1280 pair, md = 4, unit-normal inputs from a seed) times both in the
order old, new, new, old: device ms from torch.profiler and ms per call by
CUDA events over back-to-back calls. Checks that the two agree within
1e-5 max|old| + 1e-6. With --sweep it times, at each level, the device
ms (torch.profiler, and per launch of a CUDA graph of 50 launches) of
every mapping the source takes (pixels per thread 1, 2, 4 x cluster
1, 2, 4, 8), for the current source through its operator
`torch.ops.dsfm_corr.local_correlation` and for each --variant (a source
with the current C entry point, called with ctypes). With --warped-plans
it times, at PWC-DC's levels 5..2 of a slice-2 pair (b = 1, 384x1280) and
of a training step (b = 4, 256x768), in bf16 and float32 (unit-normal
channels-last features, a flow of up to 3 px at the level's scale, from a
seed), every
mapping the warped correlation takes (pixels per thread 1, 2 x cluster 1,
2, 4, 8): device ms (torch.profiler), ms per launch
of a CUDA graph of 50 launches, and the registers, shared memory and
resident blocks of each; beside `warped_plan`'s choice. Its timing in
turns against an earlier source is `chip_smoke.py --old-b2`'s. With
--backward-plans it times, at PWC-DC's correlations of a b = 4, 256x768
training step (B2's level 6 in float32, the warped levels 5..2 in bf16
and float32; unit-normal features, a flow of up to 3 px at the level's
scale and a dout that is a channel slice of a channels-last gradient, as
PWC-DC's decoder hands it, from a seed), every mapping the backward source
takes (`local_corr.backward_mappings`: tile x slots), each held to its
plain version first: ms per call by CUDA-graph replay of 20 calls (the
whole call: d f2's fill, the kernel, the bf16 cast), and the registers,
shared memory and resident blocks of each; device ms (torch.profiler, the
kernel alone and the whole call) of `backward_plan`'s choice and of the
fastest; with --old-backward an earlier `warped_corr_backward.cu` (no
mapping arguments) in turns with the plan's, old, new, new, old, by CUDA
graph. Prints the card line, one line per level and, as the last line, one
JSON object; writes the same object to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

import chip_smoke as smoke

LEVELS = [(1, 6, 20, 196), (1, 12, 40, 128), (1, 24, 80, 96), (1, 48, 160, 64),
          (1, 96, 320, 32)]
# the warped correlation's (B, C, H, W) and flow scale at PWC-DC's levels
# 5..2: a slice-2 pair (384x1280), then a training step (b = 4, 256x768)
WARPED_LEVELS = [((1, 128, 12, 40), 0.625), ((1, 96, 24, 80), 1.25), ((1, 64, 48, 160), 2.5),
                 ((1, 32, 96, 320), 5.0), ((4, 128, 8, 24), 0.625), ((4, 96, 16, 48), 1.25),
                 ((4, 64, 32, 96), 2.5), ((4, 32, 64, 192), 5.0)]


def old_kernel(path: Path):
    """The older source, built by `ops/cuda/build.py`, behind a call like B2's."""
    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    class OldKernel(CudaKernel):
        source = str(path.resolve())   # an absolute path replaces csrc/

        def _bind(self, lib):
            fn = lib.dsfm_local_correlation
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

        def __call__(self, f0, f1, md):
            B, H, W, C = f0.shape
            out = torch.empty((B, H, W, (2 * md + 1) ** 2), dtype=torch.float32,
                              device=f0.device)
            err = self.build().dsfm_local_correlation(
                f0.data_ptr(), f1.data_ptr(), out.data_ptr(), B, H, W, C, md,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"old B2 launch failed: cudaError {err}")
            return out

    return OldKernel()


def variant_launcher(path: Path):
    """`launch(f0, f1, out, md, px, cluster)` of another source with the
    current C entry point, built by `ops/cuda/build.py`."""
    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    class Variant(CudaKernel):
        source = str(path.resolve())   # an absolute path replaces csrc/

        def _bind(self, lib):
            fn = lib.dsfm_local_correlation
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

    lib = Variant().build()

    def launch(f0, f1, out, md, px, cluster):
        err = lib.dsfm_local_correlation(f0.data_ptr(), f1.data_ptr(), out.data_ptr(),
                                         *f0.shape, md, px, cluster,
                                         torch.cuda.current_stream().cuda_stream)
        smoke.check(err == 0, f"{path} {tuple(f0.shape)} px {px} cluster {cluster}: "
                    f"cudaError {err}")

    return launch


def current_launcher():
    """The same call of the current source, through its operator."""
    from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr

    op = local_corr.OPS.build().local_correlation.default
    return lambda f0, f1, out, md, px, cluster: op(f0, f1, md, px, cluster)


def sweep(launch, md: int, generator) -> list[dict]:
    """Device ms of every (px, cluster) mapping at each level, `launch` as
    `variant_launcher` or `current_launcher` give it."""
    from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr

    rows = []
    for shape in LEVELS:
        f0, f1 = (torch.randn(shape, device="cuda", generator=generator) for _ in range(2))
        out = torch.empty(shape[:3] + ((2 * md + 1) ** 2,), device="cuda")
        times, graph = {}, {}
        for px in local_corr.PIXELS_PER_THREAD:
            for cluster in (1, 2, 4, 8):
                if cluster > -(-shape[-1] // 4):
                    continue

                def call(px=px, cluster=cluster):
                    launch(f0, f1, out, md, px, cluster)

                key = f"px{px}_cluster{cluster}"
                times[key] = smoke.device_ms(call, "local_corr_kernel", reps=50)
                graph[key] = smoke.graph_ms(call, reps=50)
        p = local_corr.plan(*shape, md)
        best = min(times, key=lambda k: float("inf") if times[k] is None else times[k])
        rows.append({"f0": list(shape), "device_ms": times, "graph_ms": graph, "best": best,
                     "plan": f"px{p.px}_cluster{p.cluster}"})
        smoke.log(f"b2_compare sweep {tuple(shape)}: best {best} {times[best]} ms (graph "
                  f"{graph[best]:.5f}), plan {rows[-1]['plan']} {times[rows[-1]['plan']]} ms "
                  f"(graph {graph[rows[-1]['plan']]:.5f})")
    return rows


def warped_plans(md: int, generator) -> list[dict]:
    """Device ms of every (px, cluster) mapping of the warped
    correlation at each of `WARPED_LEVELS`, in bf16 and float32."""
    from deep_sfm_revisited_tpu_torch.ops import correlation
    from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr

    op = local_corr.OPS.build().warped_correlation.default
    rows = []
    for (B, C, H, W), scale in WARPED_LEVELS:
        for dtype in (torch.bfloat16, torch.float32):
            f1, f2 = (torch.randn((B, C, H, W), device="cuda", generator=generator).to(dtype)
                      .contiguous(memory_format=torch.channels_last) for _ in range(2))
            flow = ((torch.rand((B, 2, H, W), device="cuda", generator=generator) - 0.5)
                    * (6.0 / scale)).to(dtype)
            want = local_corr.warped_correlation_cuda(f1, f2, flow, scale, md)
            ref = correlation.warped_correlation_nchw_plain(f1, f2, flow, scale, md).float()
            tol = 1e-5 * float(ref.abs().max()) + 1e-6
            if dtype == torch.bfloat16:
                tol = tol + smoke._bf16_ulp(ref)
            smoke.check(bool(((want.float() - ref).abs() <= tol).all()),
                        f"{(B, C, H, W)} {dtype}: the plan's kernel against its plain version")
            times, graph, res = {}, {}, {}
            for px in local_corr.WARPED_PIXELS:
                for cluster in (1, 2, 4, 8):
                    if cluster > -(-C // 4):
                        continue

                    def call(px=px, cluster=cluster):
                        return op(f1, f2, flow, scale, md, px, cluster)

                    got = call()
                    smoke.check(bool(((got.float() - ref).abs() <= tol).all()),
                                f"{(B, C, H, W)} px {px} cluster {cluster}: "
                                f"{float((got.float() - ref).abs().max())}")
                    key = f"px{px}_cluster{cluster}"
                    times[key] = smoke.device_ms(call, "warped_corr_kernel", reps=50)
                    graph[key] = smoke.graph_ms(call, reps=50)
                    res[key] = local_corr.WARPED.resources(
                        local_corr.warped_mapping(B, C, H, W, md, px, cluster), dtype)
            p = local_corr.warped_plan(B, C, H, W, md)
            plan = f"px{p.px}_cluster{p.cluster}"
            best = min(graph, key=graph.get)
            rows.append({"f1": [B, C, H, W], "dtype": str(dtype)[6:], "scale": scale,
                         "device_ms": times, "graph_ms": graph, "resources": res,
                         "best_by_graph": best, "plan": plan})
            smoke.log(f"b2_compare warped {(B, C, H, W)} {str(dtype)[6:]}: best {best} "
                      f"{graph[best]:.5f} ms by graph (device {times[best]}), plan {plan} "
                      f"{graph[plan]:.5f} (device {times[plan]}); "
                      + ", ".join(f"{k} {v:.5f}" for k, v in sorted(graph.items(),
                                                                   key=lambda kv: kv[1])))
    return rows


# PWC-DC's correlations at a b = 4, 256x768 training step: B2's level 6
# (B, H, W, C), then the warped correlation's levels 5..2 (B, C, H, W) and
# the flow's scale
BACKWARD_B2 = (4, 4, 12, 196)
BACKWARD_LEVELS = [((4, 128, 8, 24), 0.625), ((4, 96, 16, 48), 1.25), ((4, 64, 32, 96), 2.5),
                   ((4, 32, 64, 192), 5.0)]


def _backward_cases(md: int, generator):
    """(kind, dtype, args) at each level: B2's float32 maps, and the warped
    levels' channels-last features, flow and a dout sliced from a
    channels-last gradient of 81 + C + 4 channels."""
    g = generator
    f0, f1 = (torch.randn(BACKWARD_B2, device="cuda", generator=g) for _ in range(2))
    dout = torch.randn((*BACKWARD_B2[:3], (2 * md + 1) ** 2), device="cuda", generator=g)
    yield "b2", torch.float32, (f0, f1, dout, md)
    for (B, C, H, W), scale in BACKWARD_LEVELS:
        for dtype in (torch.bfloat16, torch.float32):
            f1, f2 = (torch.randn((B, C, H, W), device="cuda", generator=g).to(dtype)
                      .contiguous(memory_format=torch.channels_last) for _ in range(2))
            flow = ((torch.rand((B, 2, H, W), device="cuda", generator=g) - 0.5)
                    * (6.0 / scale)).to(dtype)
            whole = torch.randn((B, (2 * md + 1) ** 2 + C + 4, H, W), device="cuda",
                                generator=g).to(dtype).contiguous(memory_format=torch.channels_last)
            yield "warped", dtype, (f1, f2, flow, scale, whole[:, :(2 * md + 1) ** 2], md)


def backward_plans(md: int, generator, old_source: str | None = None) -> list[dict]:
    """Every mapping of the backward kernels at each training-step level
    (see the module's docstring), beside `backward_plan`'s choice."""
    from deep_sfm_revisited_tpu_torch.ops import correlation
    from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr

    old = smoke.old_corr_backward(Path(old_source)) if old_source else None
    rows = []
    for kind, dtype, args in _backward_cases(md, generator):
        if kind == "b2":
            B, H, W, C = args[0].shape
            run, plain, flow = (local_corr.local_correlation_backward_cuda,
                                correlation.local_correlation_backward_plain, False)
        else:
            B, C, H, W = args[0].shape
            run, plain, flow = (local_corr.warped_correlation_backward_cuda,
                                correlation.warped_correlation_nchw_backward_plain, True)
        ref = plain(*args)
        itemsize = torch.empty((), dtype=dtype).element_size()
        graph, res = {}, {}
        for p in local_corr.backward_mappings(B, C, H, W, md, itemsize, flow):
            def call(p=p):
                return run(*args, plan=p)

            for name, got, want in zip(("d f1", "d f2", "d flow"), call(), ref):
                err = (got.float() - want.float()).abs()
                smoke.check(bool((err <= smoke._grad_tol(got, want)).all()),
                            f"{kind} {(B, C, H, W)} {dtype} {p.key} {name}: max |kernel - "
                            f"plain| {float(err.max())}")
            graph[p.key] = smoke.graph_ms(call)
            res[p.key] = local_corr.BACKWARD.resources(p, C, md, dtype, flow)
        p = local_corr.backward_plan(B, C, H, W, md, dtype, flow)
        best = min(graph, key=graph.get)
        device = {}
        for key in dict.fromkeys((p.key, best)):
            q = next(m for m in local_corr.backward_mappings(B, C, H, W, md, itemsize, flow)
                     if m.key == key)
            prof = smoke._full_profile(lambda q=q: run(*args, plan=q))
            device[key] = {"whole": smoke._profile_sums(prof)[0],
                           "kernel": None if prof is None else sum(
                               v[0] for n, v in prof.items() if "corr_backward_kernel" in n)}
        row = {"kind": kind, "shape": [B, C, H, W], "dtype": str(dtype)[6:], "graph_ms": graph,
               "resources": res, "best_by_graph": best, "plan": p.key, "device_ms": device}
        if old is not None:
            fn = old[0] if kind == "b2" else old[1]
            turns = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                turns[who].append(smoke.graph_ms((lambda: fn(*args)) if who == "old"
                                                 else (lambda: run(*args))))
            row["old_graph_ms"], row["new_graph_ms"] = turns["old"], turns["new"]
        rows.append(row)
        smoke.log(f"b2_compare backward {kind} {(B, C, H, W)} {row['dtype']}: best {best} "
                  f"{graph[best]:.5f} ms by graph {res[best]}, plan {p.key} {graph[p.key]:.5f} "
                  f"{res[p.key]}; device {device}"
                  + (f"; old {row['old_graph_ms']} new {row['new_graph_ms']}" if old else "")
                  + "; " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(graph.items(),
                                                                      key=lambda kv: kv[1])[:8]))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="the earlier local_corr.cu, timed in turns with the current")
    ap.add_argument("--sweep", action="store_true", help="time every mapping at each level")
    ap.add_argument("--warped-plans", action="store_true",
                    help="time every mapping of the warped correlation at PWC-DC's levels 5..2")
    ap.add_argument("--backward-plans", action="store_true",
                    help="time every mapping of the backward kernels at the training step's "
                         "levels")
    ap.add_argument("--old-backward", default=None,
                    help="an earlier warped_corr_backward.cu timed in turns with the plan's "
                         "mapping (with --backward-plans)")
    ap.add_argument("--variant", action="append", default=[],
                    help="another source with the current C entry point, swept too")
    ap.add_argument("--out", default="b2_compare_out/b2_compare.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b2_compare: no CUDA device", file=sys.stderr)
        return 2
    from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr

    card = smoke.phase_setup(local_corr)
    md = smoke.B2_MD
    g = torch.Generator(device="cuda").manual_seed(0)
    summary = {"card": card}
    if args.sweep:
        summary["sweep"] = {"current": sweep(current_launcher(), md, g)}
        for path in args.variant:
            smoke.log(f"b2_compare: variant {path}")
            summary["sweep"][path] = sweep(variant_launcher(Path(path)), md, g)
    if args.warped_plans:
        summary["warped_plans"] = warped_plans(md, g)
    if args.backward_plans:
        summary["backward_plans"] = backward_plans(md, g, args.old_backward)
    if args.old:
        summary.update(compare(Path(args.old), local_corr, md, g))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


def compare(path: Path, local_corr, md: int, g) -> dict:
    """The older source and the current one in turns at each level."""
    old = old_kernel(path)
    old.build()
    new = local_corr.local_correlation_cuda
    rows = []
    for shape in LEVELS:
        f0 = torch.randn(shape, device="cuda", generator=g)
        f1 = torch.randn(shape, device="cuda", generator=g)
        a, b = old(f0, f1, md), new(f0, f1, md)
        err = float((a - b).abs().max())
        smoke.check(err <= 1e-5 * float(a.abs().max()) + 1e-6, f"{shape}: old vs new {err}")
        t = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            fn = (lambda: old(f0, f1, md)) if who == "old" else (lambda: new(f0, f1, md))
            t[who].append((smoke.device_ms(fn, "local_corr_kernel", reps=50),
                           smoke.cuda_ms(fn, reps=200)))
        p = local_corr.plan(*shape, md)
        row = {"f0": list(shape), "px": p.px, "cluster": p.cluster, "warps": p.warps,
               "max_abs_diff": err,
               "old_device_ms": [d for d, _ in t["old"]], "new_device_ms": [d for d, _ in t["new"]],
               "old_events_ms": [e for _, e in t["old"]], "new_events_ms": [e for _, e in t["new"]]}
        rows.append(row)
        smoke.log(f"b2_compare {tuple(shape)}: device ms old {row['old_device_ms']} new "
                  f"{row['new_device_ms']}; events ms old {row['old_events_ms']} new "
                  f"{row['new_events_ms']}; px {p.px} cluster {p.cluster} warps {p.warps}")
    summary = {"levels": rows}
    for who in ("old", "new"):
        for kind in ("device", "events"):
            key = f"{who}_{kind}_ms"
            summary[f"{key}_per_pair"] = [sum(r[key][i] for r in rows) for i in range(2)]
    return summary


if __name__ == "__main__":
    sys.exit(main())
