#!/usr/bin/env python3
"""B1's sweep backward, sweep pose gradient and displacement volume against
other sources of themselves, in turns, on one card; and the work mappings of
the current source, to check `ops/cuda/sweep_warp.py::backward_plan`'s
choice.

    git show <commit>:deep_sfm_revisited_tpu_torch/csrc/sweep_warp.cu > local/sweep_warp_old.cu
    python3 chip_smoke.py --save-sweep-inputs local/sweep_inputs.pt   # slice 5's pose
    python3 b1_compare.py --old local/sweep_warp_old.cu --pose local/sweep_inputs.pt \\
        [--plans] [--out local/b1_compare.json]                 # needs one CUDA device

At slice 5's training shape (dvol (4, 128, 64, 192, 64) bfloat16, unit
normal from a seed) and pose (`--pose`: the depths, M and K t that
`chip_smoke.py` saves from its training run; without it a synthetic
forward motion at KITTI's focal length): builds the older source (its C
entry point `dsfm_plane_sweep_volume_backward`, which has kept its
arguments) beside the current one, checks that both agree with the plain
VJP, and times them in the order old, new, new, old: device ms from
torch.profiler and ms per call by CUDA events. With --plans it prints, for
each work mapping (tile shape x planes a group x shared accumulator size,
the grid given by --tiles, --planes and --smem-kb),
the distribution of box sizes under the plain box rule, the groups on each
path, the 16-byte global reductions and the device ms. Prints the card
line, one line per measurement and, as the last line, one JSON object;
writes the same object to --out. --turns times the mappings it lists by
CUDA events in turns; with --variant, each beside the same mapping of
another source that has the current probe entry point.

    python3 b1_compare.py --pose-grad [--pose <saved inputs>] [--sources a.cu,b.cu]
    python3 chip_smoke.py --save-disp-inputs local/disp_inputs.pt     # optional
    python3 b1_compare.py --volume [--inputs local/disp_inputs.pt] --sources a.cu,b.cu
    python3 b1_compare.py --volume-plans [--inputs local/disp_inputs.pt]

--pose-grad times the sweep pose gradient at the POSENET step's shape (the
same dvol, a target map of unit normals, the --pose or synthetic pose): the
current source and each of --sources (earlier or variant sources of
`sweep_warp.cu` with the same C entry points), each held to the plain
version to 1e-5 of its largest value, then timed by torch.profiler in
turns, in the order given and back. --volume does the same for DICL's
displacement volume (bit for bit) with earlier sources whose entry point
takes `pair_io` (`chip_smoke.old_displacement_volume`), at slice 1's five
levels and the training step's five: on the inputs `chip_smoke.py
--save-disp-inputs` saved (`--inputs`), or on bf16 unit normals and flows
of a few pixels at those shapes. --volume-plans times a grid of the current
kernel's work mappings per level beside `displacement_plan`'s choice and a
fill of the stack's size (the card's write rate).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import sys
from pathlib import Path

import torch

import chip_smoke as smoke

SHAPE = (4, 128, 64, 192, 32)            # B, D, H, W, C: slice 5 at 1/4 of 256x768
TILES = "8x8,4x16,2x32,16x4"         # the --plans grid, by default
PLANES = "4,8,16,32"
SMEM_KB = "24,48,96,192"


def old_kernel(path: Path):
    """The older source, built by `ops/cuda/build.py`, behind a call like the
    sweep backward's wrapper."""
    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    class OldKernel(CudaKernel):
        source = str(path.resolve())   # an absolute path replaces csrc/

        def _bind(self, lib):
            fn = lib.dsfm_plane_sweep_volume_backward
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

        def __call__(self, dvol, depths, M, Kt):
            B, D, H, W, C2 = dvol.shape
            C = C2 // 2
            dref = torch.empty((B, H, W, C), dtype=dvol.dtype, device=dvol.device)
            acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=dvol.device)
            err = self.build().dsfm_plane_sweep_volume_backward(
                dvol.data_ptr(), depths.data_ptr(), M.data_ptr(), Kt.data_ptr(),
                dref.data_ptr(), acc.data_ptr(), B, D, H, W, C, 1,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"old sweep backward launch failed: cudaError {err}")
            return dref, acc.to(dvol.dtype)

    return OldKernel()


def variant_kernel(path: Path):
    """A source with the current probe entry point
    (`dsfm_plane_sweep_volume_backward_probe`), built beside the current one
    and called through ctypes with a work mapping."""
    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    class Variant(CudaKernel):
        source = str(path.resolve())

        def _bind(self, lib):
            fn = lib.dsfm_plane_sweep_volume_backward_probe
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int

        def __call__(self, dvol, depths, M, Kt, plan):
            B, D, H, W, C2 = dvol.shape
            C = C2 // 2
            dref = torch.empty((B, H, W, C), dtype=dvol.dtype, device=dvol.device)
            acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=dvol.device)
            err = self.build().dsfm_plane_sweep_volume_backward_probe(
                dvol.data_ptr(), depths.data_ptr(), M.data_ptr(), Kt.data_ptr(),
                dref.data_ptr(), acc.data_ptr(), B, D, H, W, C, 1, *plan, None,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"variant launch failed: cudaError {err}")
            return dref, acc

    return Variant()


def inputs(pose: str | None, generator):
    """dvol (bf16, unit normal), depths, M, Kt on the card."""
    from deep_sfm_revisited_tpu_torch.ops import camera, rotations

    B, D, H, W, C = SHAPE
    if pose:
        saved = torch.load(pose, weights_only=True)
        depths, M, Kt = (saved[k].cuda() for k in ("depths", "M", "Kt"))
        smoke.check(list(saved["dvol_shape"]) == [B, D, H, W, 2 * C],
                    f"saved inputs of shape {saved['dvol_shape']}")
    else:
        f = 718.856 / 4                 # KITTI's focal length at 1/4 resolution
        K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], device="cuda")
        R = rotations.angle_to_matrix(torch.tensor([0.005, -0.01, 0.002], device="cuda"))
        pose_ = torch.cat([R, torch.tensor([[0.02], [0.0], [0.999]], device="cuda")], dim=1)
        M, Kt = camera.sweep_matrices(pose_.expand(B, 3, 4), K.expand(B, 3, 3),
                                      torch.linalg.inv(K).expand(B, 3, 3))
        depths = D / torch.arange(1, D + 1, dtype=torch.float32, device="cuda")  # PSNet's
    dvol = torch.randn((B, D, H, W, 2 * C), device="cuda", generator=generator)
    return dvol.to(torch.bfloat16), depths.contiguous(), M.contiguous(), Kt.contiguous()


def within_tolerance(got, want) -> bool:
    """`chip_smoke.phase_sweep_backward`'s bf16 rule."""
    err = (got.float() - want.float()).abs()
    tol = 1e-5 * float(want.float().abs().max()) + 1e-6
    tol = tol + smoke._bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    return bool((err <= tol).all())


def plans(dvol, depths, M, Kt, sweep_warp, camera, tiles, planes_list, smem_kb) -> list[dict]:
    """Every mapping of tiles x planes x shared accumulator sizes: box sizes,
    paths, global reductions (the kernel's counts, checked against the plain
    rule's) and device ms."""
    B, D, H, W, C2 = dvol.shape
    C = C2 // 2
    rows = []
    for tile in tiles:
        for planes in planes_list:
            box = camera.sweep_tap_box_plain(depths, M, Kt, H, W, *tile, planes, 10**9)
            area = (box["w"] * box["h"])[~box["direct"]].float()
            q = torch.quantile(area, torch.tensor([0.5, 0.9, 0.99, 1.0],
                                                  device=area.device)).tolist()
            for kb in smem_kb:
                plan = (*tile, planes, kb * 1024)
                _, _, counts = sweep_warp.plane_sweep_volume_backward_probe(dvol, depths, M,
                                                                            Kt, plan)
                want = camera.sweep_backward_counts(depths, M, Kt, H, W, C, *tile, planes,
                                                    kb * 1024 // (4 * C))
                smoke.check(counts == want, f"plan {plan}: kernel {counts} != plain {want}")
                ms = smoke.device_ms(
                    lambda: sweep_warp.plane_sweep_volume_backward_probe(dvol, depths, M, Kt,
                                                                         plan),
                    "plane_sweep_volume_backward_kernel", reps=5)
                rows.append(dict(tile=list(tile), planes=planes, smem_kb=kb, device_ms=ms,
                                 box_pixels=dict(zip(("p50", "p90", "p99", "max"), q)),
                                 **counts))
                smoke.log(f"b1_compare plan tile {tile[0]}x{tile[1]}, {planes} planes, {kb} KB: "
                          f"device {ms:.4f} ms; box pixels p50 {q[0]:.0f} p90 {q[1]:.0f} p99 "
                          f"{q[2]:.0f} max {q[3]:.0f}; groups shared {counts['shared_groups']} "
                          f"direct {counts['direct_groups']}; "
                          f"{counts['global_reductions'] / 1e6:.2f} M reductions")
    return rows


def turns(dvol, depths, M, Kt, sweep_warp, spec: str, variant=None) -> list[dict]:
    """The mappings of `spec` ("HxW/planes/KB,..."), by CUDA events over 20
    back-to-back launches each, in the order given and then reversed; with a
    `variant`, each mapping of the current source and of the variant in the
    order current, variant, variant, current, after checking that they
    agree within the bf16 tolerance."""
    plans_ = [(*map(int, t.split("/")[0].split("x")), int(t.split("/")[1]),
               int(t.split("/")[2]) * 1024) for t in spec.split(",")]
    probe = sweep_warp.OPS.build().plane_sweep_volume_backward_probe   # no host sync
    runs = {"current": lambda p: probe(dvol, depths, M, Kt, *p)}
    if variant is not None:
        runs["variant"] = lambda p: variant(dvol, depths, M, Kt, p)
        for p in plans_:
            (a, b, _), (c, d) = runs["current"](p), runs["variant"](p)
            smoke.check(within_tolerance(a, c) and within_tolerance(b.to(dvol.dtype),
                                                                    d.to(dvol.dtype)),
                        f"plan {p}: the variant and the current source disagree")
    times = {(who, p): [] for who in runs for p in plans_}
    order = ([("current", p) for p in plans_] + [("current", p) for p in plans_][::-1]
             if variant is None else
             [(w, p) for p in plans_ for w in ("current", "variant", "variant", "current")])
    for who, p in order:
        times[who, p].append(smoke.cuda_ms(lambda: runs[who](p), reps=20))
    rows = [dict(source=who, plan=list(p), events_ms=t) for (who, p), t in times.items()]
    for r in rows:
        smoke.log(f"b1_compare in turns: {r['source']} plan {r['plan']}: events ms "
                  f"{r['events_ms']}")
    return rows


def compare(path: Path, dvol, depths, M, Kt, sweep_warp, camera) -> dict:
    """The older source and the current one in turns; both against the plain VJP."""
    old = old_kernel(path)
    old.build()

    def new(*a):
        return sweep_warp.plane_sweep_volume_backward_cuda(*a)

    pref, ptgt = camera.plane_sweep_volume_backward_plain(dvol, depths, M, Kt)
    for who, fn in (("old", old), ("new", new)):
        dref, dtgt = fn(dvol, depths, M, Kt)
        smoke.check(within_tolerance(dref, pref) and within_tolerance(dtgt, ptgt),
                    f"the {who} kernel is not within tolerance of the plain VJP")
    del pref, ptgt
    t = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        fn = old if who == "old" else new
        run = lambda: fn(dvol, depths, M, Kt)   # noqa: E731
        t[who].append((smoke.device_ms(run, "plane_sweep_volume_backward_kernel", reps=10),
                       smoke.cuda_ms(run, reps=10)))
    row = {"old_device_ms": [d for d, _ in t["old"]], "new_device_ms": [d for d, _ in t["new"]],
           "old_events_ms": [e for _, e in t["old"]], "new_events_ms": [e for _, e in t["new"]]}
    smoke.log(f"b1_compare sweep backward {tuple(dvol.shape)} bf16, in turns old, new, new, "
              f"old: device ms old {row['old_device_ms']} new {row['new_device_ms']}; events ms "
              f"old {row['old_events_ms']} new {row['new_events_ms']}")
    return row


def in_turns(runs: dict, kernel_name: str, reps: int = 20) -> dict:
    """Device ms of each run by torch.profiler, in the order given and back."""
    order = list(runs) + list(runs)[::-1]
    times = {name: [] for name in runs}
    for name in order:
        times[name].append(smoke.device_ms(runs[name], kernel_name, reps=reps))
    return times


def pose_grad_turns(sources, pose, sweep_warp, camera, generator) -> dict:
    """The pose gradient of the current source and of each other source at
    the POSENET step's shape, held to the plain version, timed in turns."""
    dvol, depths, M, Kt = inputs(pose, generator)
    B, _, H, W, C2 = dvol.shape
    tgt = torch.randn((B, H, W, C2 // 2), device="cuda", generator=generator).to(dvol.dtype)
    x, y = camera.sweep_pixel_coords(depths, M, Kt, H, W)
    valid = float(((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)).float().mean())
    want = camera.plane_sweep_volume_pose_grad_plain(dvol, tgt, depths, M, Kt)
    runs = {"current": lambda: sweep_warp.plane_sweep_volume_pose_grad_cuda(dvol, tgt, depths,
                                                                             M, Kt)}
    for src in sources:
        kernel = smoke.old_pose_grad_kernel(Path(src))
        runs[src] = lambda k=kernel: k(dvol, tgt, depths, M, Kt)
    for name, run in runs.items():
        for got, w in zip(run(), want):
            smoke.check(float((got - w).abs().max()) <= 1e-5 * float(w.abs().max()),
                        f"{name}: the pose gradient is not within 1e-5 of the plain version")
    times = in_turns(runs, "plane_sweep_pose_grad")
    smoke.log(f"b1_compare pose gradient {tuple(dvol.shape)} bf16, valid samples "
              f"{100 * valid:.2f}%, device ms in turns: {json.dumps(times)}")
    return {"shape": list(dvol.shape), "valid_share": valid, "device_ms": times}


# slice 1's five DICL levels (b = 1, 384x1280) and the training step's five
# (b = 4, 256x768)
VOLUME_SHAPES = [(1, 6, 20), (1, 12, 40), (1, 24, 80), (1, 48, 160), (1, 96, 320),
                 (4, 4, 12), (4, 8, 24), (4, 16, 48), (4, 32, 96), (4, 64, 192)]


def volume_inputs(saved: str | None, generator) -> list[tuple]:
    """(x, y, flow or None, md) of each level: those `chip_smoke.py
    --save-disp-inputs` saved from slice 1's pair and a training step, or at
    VOLUME_SHAPES C = 32, md = 3, bf16 unit normals and flows of a few
    pixels (none at level 6)."""
    if saved:
        stored = torch.load(saved, weights_only=True)
        return [tuple(t.cuda() if torch.is_tensor(t) else t for t in call)
                for path in ("dicl_main_path", "cli_train") for call in stored[path]]
    calls = []
    for B, h, w in VOLUME_SHAPES:
        x = torch.randn((B, 32, h, w), device="cuda", generator=generator).bfloat16()
        y = torch.randn((B, 32, h, w), device="cuda", generator=generator).bfloat16()
        flow = (None if h * 64 in (384, 256) else
                torch.randn((B, 2, h, w), device="cuda", generator=generator) * 3)
        calls.append((x, y, flow, 3))
    return calls


def _bound_ms(x, y, flow, out) -> float:
    ins = (x, y) if flow is None else (x, y, flow)
    return sum(t.numel() * t.element_size() for t in ins + (out,)) / smoke.HBM_BYTES_PER_S * 1e3


def volume_turns(sources, sweep_warp, dicl, calls) -> list[dict]:
    """The displacement volume of the current source and of each earlier
    source (`chip_smoke.old_displacement_volume`) at each level of `calls`,
    bit for bit against the plain version, device ms in turns (the
    sample and store kernels together for the current one)."""
    kernels = {src: smoke.old_displacement_volume(Path(src)) for src in sources}
    rows = []
    with torch.no_grad():
        for x, y, flow, md in calls:
            want = dicl.displacement_volume_plain(x, y, flow, md)
            runs = {"current": lambda: sweep_warp.displacement_volume_cuda(x, y, flow, md)}
            runs.update({src: (lambda k=k: k(x, y, flow, md)) for src, k in kernels.items()})
            for name, run in runs.items():
                smoke.check(torch.equal(run(), want), f"{name}: the volume differs from plain")
            row = {"shape": list(x.shape), "flow": flow is not None,
                   "bound_ms": _bound_ms(x, y, flow, want),
                   "device_ms": in_turns(runs, "displacement_volume")}
            smoke.log(f"b1_compare displacement volume {tuple(x.shape)}: bound "
                      f"{row['bound_ms']:.4f} ms, device ms in turns: "
                      f"{json.dumps(row['device_ms'])}")
            rows.append(row)
    return rows


def volume_plans(sweep_warp, dicl, calls) -> list[dict]:
    """Every work mapping of a small grid at each level of `calls` --
    bands of 1, 2, 4 rows x 1, 2, 4, 8 tiles a row, each at its persistent
    grid, twice it and a block an item, with a flow each with and without
    the sampling fused into the store kernel -- bit for bit against the plain
    version, device ms each, which the default `displacement_plan` picks
    (and its device ms kernel by kernel), and the device ms of filling a
    tensor of the stack's size (`fill_`: the card's write rate)."""
    rows = []
    with torch.no_grad():
        for x, y, flow, md in calls:
            B, C, h, w = x.shape
            want = dicl.displacement_volume_plain(x, y, flow, md)
            default = sweep_warp.DISPLACEMENT.plan(x, y, md)
            plans = [default]
            for bh in (1, 2, 4):
                for n in (1, 2, 4, 8):
                    try:
                        p = sweep_warp.displacement_plan(
                            B, C, h, w, md, x.element_size(),
                            aligned=min(sweep_warp.address_alignment(x),
                                        sweep_warp.address_alignment(y)),
                            sms=sweep_warp.device_sms(x.device), band_h=min(bh, h),
                            tiles_x=min(n, w))
                    except ValueError:
                        continue
                    plans += [dataclasses.replace(p, grid=g, fused=f)
                              for g in (p.grid, 2 * p.grid, p.items)
                              for f in ((False, True) if flow is not None else (False,))]
            seen, times = set(), []
            for p in plans:
                if p in seen:
                    continue
                seen.add(p)

                def run(p=p):
                    return sweep_warp.displacement_volume_cuda(x, y, flow, md, p)

                smoke.check(torch.equal(run(), want), f"plan {p}: differs from plain")
                times.append({**vars(p), "device_ms": smoke.device_ms(
                    run, "displacement_volume", reps=20)})
            best = min((t for t in times if t["device_ms"] is not None),
                       key=lambda t: t["device_ms"])
            by_kernel = smoke._full_profile(
                lambda: sweep_warp.displacement_volume_cuda(x, y, flow, md), reps=20)
            times[0]["by_kernel"] = by_kernel and {n[:60]: v[0] for n, v in by_kernel.items()}
            fill_ms = smoke.device_ms(lambda: want.fill_(1.0), "", reps=20)
            row = {"shape": list(x.shape), "flow": flow is not None,
                   "bound_ms": _bound_ms(x, y, flow, want), "fill_ms": fill_ms,
                   "default": times[0], "best": best, "plans": times}
            smoke.log(f"b1_compare volume plans {tuple(x.shape)}: bound {row['bound_ms']:.4f} ms, "
                      f"fill_ {smoke._fmt_ms(fill_ms)}; default {json.dumps(times[0])}; "
                      f"best {json.dumps(best)}")
            rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", help="an earlier sweep_warp.cu, timed in turns with the current")
    ap.add_argument("--pose", help="slice 5's depths, M, K t saved by chip_smoke.py")
    ap.add_argument("--plans", action="store_true", help="time every work mapping")
    ap.add_argument("--tiles", default=TILES, help="tile shapes HxW for --plans")
    ap.add_argument("--planes", default=PLANES, help="planes a group for --plans")
    ap.add_argument("--smem-kb", default=SMEM_KB, help="shared accumulators in KB for --plans")
    ap.add_argument("--turns", help="mappings HxW/planes/KB,... timed by events in turns")
    ap.add_argument("--variant", help="a source with the current probe entry, timed in turns "
                                      "with the current one at each --turns mapping")
    ap.add_argument("--pose-grad", action="store_true",
                    help="time the sweep pose gradient beside --sources in turns")
    ap.add_argument("--volume", action="store_true",
                    help="time DICL's displacement volume beside --sources in turns")
    ap.add_argument("--sources", default="",
                    help="comma-separated sweep_warp.cu files for --pose-grad and --volume")
    ap.add_argument("--inputs", help="the volume's inputs saved by chip_smoke.py "
                                     "--save-disp-inputs, for --volume and --volume-plans")
    ap.add_argument("--volume-plans", action="store_true",
                    help="time a grid of the displacement volume's work mappings per level")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b1_compare: no CUDA device", file=sys.stderr)
        return 2
    from deep_sfm_revisited_tpu_torch.models import dicl
    from deep_sfm_revisited_tpu_torch.ops import camera
    from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp

    card = smoke.phase_setup(sweep_warp)
    g = torch.Generator(device="cuda").manual_seed(0)
    sources = [p for p in args.sources.split(",") if p]
    if args.pose_grad or args.volume or args.volume_plans:
        summary = {"card": card}
        if args.pose_grad:
            summary["pose_grad"] = pose_grad_turns(sources, args.pose, sweep_warp, camera, g)
        calls = volume_inputs(args.inputs, g) if args.volume or args.volume_plans else []
        if args.volume:
            summary["volume"] = volume_turns(sources, sweep_warp, dicl, calls)
        if args.volume_plans:
            summary["volume_plans"] = volume_plans(sweep_warp, dicl, calls)
        return _emit(summary, args.out)
    dvol, depths, M, Kt = inputs(args.pose, g)
    summary = {"card": card, "shape": list(dvol.shape), "pose": args.pose or "synthetic",
               "work": smoke.backward_work(dvol, depths, M, Kt, sweep_warp, camera)}
    run = lambda: sweep_warp.plane_sweep_volume_backward_cuda(dvol, depths, M, Kt)  # noqa: E731
    summary["new_device_ms"] = smoke.device_ms(run, "plane_sweep_volume_backward_kernel", reps=10)
    summary["yardstick"] = smoke.backward_yardstick(dvol, depths, M, Kt, camera)
    smoke.log(f"b1_compare: new kernel device {summary['new_device_ms']:.4f} ms; yardstick "
              f"{json.dumps(summary['yardstick'])}")
    if args.old:
        summary["in_turns"] = compare(Path(args.old), dvol, depths, M, Kt, sweep_warp, camera)
    if args.turns:
        summary["turns"] = turns(dvol, depths, M, Kt, sweep_warp, args.turns,
                                 variant_kernel(Path(args.variant)) if args.variant else None)
    if args.plans:
        tiles = [tuple(int(v) for v in t.split("x")) for t in args.tiles.split(",")]
        summary["plans"] = plans(dvol, depths, M, Kt, sweep_warp, camera, tiles,
                                 [int(v) for v in args.planes.split(",")],
                                 [int(v) for v in args.smem_kb.split(",")])
    return _emit(summary, args.out)


def _emit(summary: dict, out: str | None) -> int:
    line = json.dumps(summary)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
