#!/usr/bin/env python3
"""Where RAFT's lookup kernels R1 and R2 spend their time, on one card.

    python3 raft_compare.py [--out raft_compare.json]     # needs one CUDA device
    python3 raft_compare.py --host-tree PATH [--out ...]  # R1's wrapper, host time

Builds variants of `csrc/raft_lookup.cu` (in parallel, one nvcc each) and
times each beside the unchanged source by CUDA-graph replay
(`chip_smoke.graph_ms`) of an eval pair's 24 R1 launches (b = 1, 384x1280)
and a b = 4, 256x768 training step's 12 R2 launches into one accumulator a
level, on a random bf16 pyramid of RAFT's shape from
`models/raft.py::correlation_pyramid` and coordinates a few pixels off the
grid, in the order listed and back:

- the mapping sweep that chose the source's queries a block: R1 with
  `kR1Queries` 8 and 16 (`r1_q8`, `r1_q16`) and R2 with `kR2Queries` 4
  and 8 (`r2_q4`, `r2_q8`) beside the shipped 4 and 2;
- one memory stream switched off: R1 without its tap loads (`r1_no_taps`)
  or its global stores (`r1_no_stores`); R2 without its tap loads
  (`r2_no_taps`), its reads of dout (`r2_no_dout`), its loads of the
  accumulator words before it adds into them (`r2_no_acc_loads`:
  partial-sector writes to sectors the cache does not hold), its stores of
  them (`r2_no_acc_stores`) or both (`r2_no_acc`: d coords alone). A
  stream's cost is read as the unchanged source minus the variant without
  it. Timing only: a stream variant's outputs are wrong by design, and
  nothing here is held to a plain version (`chip_smoke.py` phases 25 and
  27 do that).

Each variant is found by fixed pieces of the source: update them when
those lines change. With `--host-tree PATH` it instead imports the port
from the checkout at PATH (its kernels built there) and times R1's wrapper
(`ops/cuda/raft_lookup.py::raft_lookup_cuda`) over the eval pair's 24
launches: events ms (the host's pace where it is slower than the card),
host µs a call (launches without a synchronisation between them) and CUDA
graph ms; run it on two checkouts in turns to compare their wrappers'
host cost. Prints the card line, one line a shape and, as the last line,
one JSON object; writes the same object to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as smoke

R1_TAPS = "w[j] = (row && any) ? __ldg(reinterpret_cast<const unsigned*>(a) + j) : 0u;"
R1_STORE = "reinterpret_cast<uint4*>(dst)[u] = reinterpret_cast<const uint4*>(stage)[u];"
ACC_LOAD = "acc[j] = *reinterpret_cast<const unsigned*>(a);"
ACC_STORE = "reinterpret_cast<unsigned*>(a0)[j] = w;"
DOUT = ("g0[dx] = s >= 1 ? g[dx * D + s - 1] : from_float<Tg>(0.f);",
        "g1[dx] = s < D ? g[dx * D + s] : from_float<Tg>(0.f);")
QUERIES = "constexpr int kR{}Queries = {};"   # kernel, queries a block
NO_ACC_STORE = "if (w == 0x7fc07fc1u) reinterpret_cast<unsigned*>(a0)[j] = w;"


def variants(src: str) -> dict:
    """{name: source}: the other queries a block, and each stream off. R1's
    and R2's tap loads share `PatchRow::load`, so `*_no_taps` switches both
    off and is timed with the kernel it names."""
    def once(text):
        smoke.check(src.count(text) == 1, f"raft_compare: not found once: {text[:60]!r}")
        return text

    no_taps = src.replace(once(R1_TAPS), "w[j] = (row && any) ? (unsigned)(a + 4 * j) : 0u;")
    no_dout = src
    for text, fake in zip(DOUT, ("(float)(s + dx)", "(float)(s - dx)")):
        no_dout = no_dout.replace(once(text), f"{text.split(' = ')[0]} = from_float<Tg>({fake});")
    no_acc = src.replace(once(ACC_LOAD), "acc[j] = (unsigned)a;").replace(once(ACC_STORE),
                                                                          NO_ACC_STORE)
    mapped = {f"r{k}_q{n}": src.replace(once(QUERIES.format(k, shipped)), QUERIES.format(k, n))
              for k, shipped, ns in ((1, 4, (8, 16)), (2, 2, (4, 8))) for n in ns}
    return {**mapped,
        "r1_no_taps": no_taps,
        "r1_no_stores": src.replace(once(R1_STORE), "if (to_float(stage[V * u]) == 1.2345e-30f) "
                                                    "dst[V * u] = stage[V * u];"),
        "r2_no_taps": no_taps,
        "r2_no_dout": no_dout,
        "r2_no_acc_loads": src.replace(once(ACC_LOAD), "acc[j] = (unsigned)a;"),
        "r2_no_acc_stores": src.replace(once(ACC_STORE), NO_ACC_STORE),
        "r2_no_acc": no_acc,
    }


def build(name: str, text: str, build_dir: Path):
    """A variant's library, built by `ops/cuda/build.py` from a copy of the
    source in `build_dir`, with the launchers' argument types bound."""
    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    path = build_dir / f"raft_lookup_{name}.cu"
    path.write_text(text)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    class Variant(CudaKernel):
        source = str(path.resolve())   # an absolute path replaces csrc/

        def _bind(self, lib):
            lib.dsfm_raft_lookup.argtypes = [P, P, P, I, P, P, LL, I, I, I, P]
            lib.dsfm_raft_lookup.restype = I
            lib.dsfm_raft_lookup_backward.argtypes = [P, P, P, P, I, P, P, P, LL, I, I, I, P]
            lib.dsfm_raft_lookup_backward.restype = I

    return Variant().build()


def _table(vals, kind=ctypes.c_void_p):
    return ctypes.cast((kind * len(vals))(*vals), ctypes.c_void_p)


def launchers(lib, levels):
    """R1 and R2 of a variant library, called as the operators call them."""
    I = ctypes.c_int
    ptrs = _table([t.data_ptr() for t in levels])
    hs, ws = _table([t.shape[1] for t in levels], I), _table([t.shape[2] for t in levels], I)
    bf16 = int(levels[0].dtype == torch.bfloat16)

    def r1(coords, out):
        err = lib.dsfm_raft_lookup(ptrs, hs, ws, len(levels), coords.data_ptr(), out.data_ptr(),
                                   coords.numel() // 2, 4, bf16, 1,
                                   torch.cuda.current_stream().cuda_stream)
        smoke.check(err == 0, f"raft_compare: R1 launch failed: cudaError {err}")

    def r2(coords, dout, acc, dc):
        err = lib.dsfm_raft_lookup_backward(
            ptrs, _table([t.data_ptr() for t in acc]), hs, ws, len(levels), coords.data_ptr(),
            dout.data_ptr(), dc.data_ptr(), coords.numel() // 2, 4, bf16, 1,
            torch.cuda.current_stream().cuda_stream)
        smoke.check(err == 0, f"raft_compare: R2 launch failed: cudaError {err}")

    return r1, r2


def inputs(B, h, w, n, seed=0):
    """A bf16 pyramid of RAFT's shape and `n` coordinate maps and bf16
    gradients, on the card."""
    from deep_sfm_revisited_tpu_torch.models import raft

    g = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn(B, 256, h, w, device="cuda", generator=g)
    f2 = torch.randn(B, 256, h, w, device="cuda", generator=g)
    levels = raft.correlation_pyramid(f1, f2, 4)
    gy, gx = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float32),
                            torch.arange(w, device="cuda", dtype=torch.float32), indexing="ij")
    grid = torch.stack([gx, gy], -1)[None].expand(B, h, w, 2)
    coords = [(grid + 3 * torch.randn(B, h, w, 2, device="cuda", generator=g)).contiguous()
              for _ in range(n)]
    douts = [(1e-3 * torch.randn(B, h, w, 324, device="cuda", generator=g)).bfloat16()
             for _ in range(n)]
    return levels, coords, douts


def host_times(tree: str) -> dict:
    """R1's wrapper of the checkout at `tree` over the eval pair's 24
    launches: events ms, host µs a call, CUDA-graph ms."""
    sys.path.insert(0, str(Path(tree).resolve()))
    from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup

    smoke.check(Path(raft_lookup.__file__).is_relative_to(Path(tree).resolve()),
                f"raft_compare: imported {raft_lookup.__file__}, not from {tree}")
    card = smoke.phase_setup(raft_lookup)
    levels, coords, _ = inputs(1, 48, 160, 24)

    def run():
        for c in coords:
            raft_lookup.raft_lookup_cuda(c, levels, 4, torch.bfloat16)

    events = [smoke.cuda_ms(run, reps=20) for _ in range(3)]
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            run()
        host.append(1e6 * (time.perf_counter() - t0) / (20 * len(coords)))
        torch.cuda.synchronize()
    graph = smoke.graph_ms(run, reps=5)
    summary = {"card": card, "tree": tree, "wrapper": raft_lookup.__file__,
               "events_ms_a_pair": events, "host_us_a_call": host, "graph_ms_a_pair": graph}
    smoke.log(f"raft_compare host {tree}: R1's wrapper over an eval pair's 24 launches: events "
              f"{[round(v, 4) for v in events]} ms, host {[round(v, 2) for v in host]} µs a "
              f"call, CUDA graph {graph:.4f} ms")
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--host-tree", help="time R1's wrapper from the checkout at this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("raft_compare: no CUDA device", file=sys.stderr)
        return 2
    if args.host_tree:
        summary = host_times(args.host_tree)
    else:
        summary = compare()
    line = json.dumps(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


def compare() -> dict:
    """The mapping sweep and the stream variants beside the source."""
    from deep_sfm_revisited_tpu_torch.models import raft
    from deep_sfm_revisited_tpu_torch.ops.cuda import raft_lookup
    from deep_sfm_revisited_tpu_torch.ops.cuda.build import BUILD_DIR

    card = smoke.phase_setup(raft_lookup)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = (Path(raft_lookup.__file__).parents[2] / "csrc" / "raft_lookup.cu").read_text()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:   # one nvcc a variant
        futures = {name: pool.submit(build, name, text, BUILD_DIR)
                   for name, text in variants(src).items()}
        libs = {name: f.result() for name, f in futures.items()}
    smoke.log(f"raft_compare: {len(libs)} variants built in {time.perf_counter() - t0:.1f} s")
    summary = {"card": card, "r1_queries": raft_lookup.R1_QUERIES,
               "r2_queries": raft_lookup.R2_QUERIES}
    for tag, (B, h, w, n) in (("eval_pair", (1, 48, 160, 24)), ("train_step", (4, 32, 96, 12))):
        levels, coords, douts = inputs(B, h, w, n)
        out = torch.empty(B, h, w, 324, dtype=torch.bfloat16, device="cuda")
        acc = raft.zeros_like_pyramid(levels)
        dc = torch.empty_like(coords[0])
        runs = {
            "r1": lambda: [raft_lookup.raft_lookup_cuda(c, levels, 4, torch.bfloat16)
                           for c in coords],
            "r2": lambda: [raft_lookup.raft_lookup_backward_cuda(c, levels, d, 4, acc)
                           for c, d in zip(coords, douts)],
        }
        for name, lib in libs.items():
            r1, r2 = launchers(lib, levels)
            runs[name] = ((lambda r1: lambda: [r1(c, out) for c in coords])(r1)
                          if name.startswith("r1") else
                          (lambda r2: lambda: [r2(c, d, acc, dc)
                                               for c, d in zip(coords, douts)])(r2))
        times = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:   # in the order listed and back
            times[k].append(smoke.graph_ms(runs[k], reps=1))
        summary[tag] = {"shape": [B, h, w], "launches": n, "graph_ms": times}
        smoke.log(f"raft_compare {tag} ({n} launches, b = {B}, {8 * h}x{8 * w}): "
                  + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in times.items()) + " ms")
    return summary


if __name__ == "__main__":
    sys.exit(main())
