#!/usr/bin/env python3
"""Where PWC-DC's correlation backward kernels spend their time, on one card.

    python3 corr_backward_probe.py [--out chiprun_out/corr_backward_probe.json]

Builds variants of `csrc/warped_corr_backward.cu` with parts of the kernel
switched off -- the register-tiled sums (`no_sums`), d f2's atomics
(`no_atomics`), both stagings of dout (`no_dout`), all three (`rest`) --
beside the unchanged source (`base`), and times each by CUDA-graph replay
(`chip_smoke.graph_ms`: the kernel and, in bf16, d f2's cast; the buffer is
zeroed once outside) at a b = 4, 256x768 training step's levels
(`b2_compare.py`'s unit-normal inputs, dout a channel slice as PWC-DC's
decoder hands it) under `local_corr.backward_plan`'s mapping. A part's cost
is read as base minus the variant without it. Timing only: a variant's
gradients are wrong by design, and nothing here is held to a plain
version. Prints the card line, one line per level and, as the last line,
one JSON object; writes the same object to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import b2_compare
import chip_smoke as smoke

VARIANTS = {"base": [], "no_sums": ["NO_SUMS"], "no_atomics": ["NO_ATOMICS"],
            "no_dout": ["NO_DOUT"], "rest": ["NO_SUMS", "NO_ATOMICS", "NO_DOUT"]}
ATOMICS_END = "atomicAdd(acc + i11 + e, p11[e]);\n                }\n              }\n"


def instrumented(src: str) -> str:
    """The source with each part behind its switch: the two sums' calls
    and the atomics' if/else in `#ifndef`, the two dout stagings behind
    `if (!NO_DOUT)`. Fails where a piece is not found exactly once."""
    def once(text):
        smoke.check(src.count(text) == 1, f"corr_backward_probe: not found once: {text[:60]!r}")
        return text

    for flag in ("false", "true"):
        call = once(f"  window_sums<MD, T, RUN, {flag}>"
                    "(a, halo, L.qp, L.hw, gs, goff, row, cr, s);\n")
        src = src.replace(call, f"#ifndef NO_SUMS\n{call}#endif\n")
    start = src.index(once("              if (red4) {\n"))
    end = src.index(once(ATOMICS_END), start) + len(ATOMICS_END)
    src = src[:start] + "#ifndef NO_ATOMICS\n" + src[start:end] + "#endif\n" + src[end:]
    for head in ("  staged<kBatch>(\n      npix * S2,", "  {\n    constexpr int NW = "):
        src = src.replace(once(head), "  if (!NO_DOUT)\n" + head)
    return "#ifndef NO_DOUT\n#define NO_DOUT 0\n#endif\n" + src


def build_variants():
    """{variant: ctypes library}, compiled in parallel into the build directory."""
    from deep_sfm_revisited_tpu_torch.ops.cuda import build

    src = (build.CSRC / "warped_corr_backward.cu").read_text()
    work = build.BUILD_DIR / "probe"
    work.mkdir(parents=True, exist_ok=True)
    path = work / "warped_corr_backward_probe.cu"
    path.write_text(instrumented(src))
    procs = {}
    for name, flags in VARIANTS.items():
        lib = work / f"libprobe_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *(f"-D{f}" for f in flags), str(path), "-o",
             str(lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        smoke.check(proc.returncode == 0, f"corr_backward_probe: {name} failed to build:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        cdll.dsfm_local_correlation_backward.argtypes = [P] * 5 + [I] * 9 + [P]
        cdll.dsfm_warped_correlation_backward.argtypes = (
            [P] * 3 + [I] * 5 + [ctypes.c_float, P, ctypes.c_longlong, ctypes.c_longlong]
            + [P] * 4 + [I] * 4 + [I] * 10 + [P])
        libs[name] = cdll
    return libs


def caller(lib, kind, args, p):
    """One launch of `lib`'s kernel (and cast) on `args` under mapping `p`."""
    stream = lambda: torch.cuda.current_stream().cuda_stream   # noqa: E731
    if kind == "b2":
        f0, f1, dout, md = args
        B, H, W, C = f0.shape
        d0, d1 = torch.empty_like(f0), torch.empty_like(f1)

        def call():
            err = lib.dsfm_local_correlation_backward(
                f0.data_ptr(), f1.data_ptr(), dout.data_ptr(), d0.data_ptr(), d1.data_ptr(), B, H,
                W, C, md, p.tile_h, p.tile_w, p.run, p.slots, stream())
            smoke.check(err == 0, f"corr_backward_probe: launch failed: cudaError {err}")
        return call
    f1, f2, flow, scale, dout, md = args
    B, C, H, W = f1.shape
    cl = torch.channels_last
    df1 = torch.empty_like(f1, memory_format=cl)
    acc = torch.zeros((B, C, H, W), device=f1.device).contiguous(memory_format=cl)
    df2 = acc if f1.dtype == torch.float32 else torch.empty_like(f1, memory_format=cl)
    dflow = torch.empty_like(flow)

    def call():
        err = lib.dsfm_warped_correlation_backward(
            f1.data_ptr(), f2.data_ptr(), flow.data_ptr(), int(flow.dtype == torch.bfloat16),
            *flow.stride(), ctypes.c_float(scale), dout.data_ptr(), dout.stride(0),
            dout.stride(3), df1.data_ptr(), df2.data_ptr(), acc.data_ptr(), dflow.data_ptr(),
            *dflow.stride(), B, H, W, C, md, int(f1.dtype == torch.bfloat16), p.tile_h, p.tile_w,
            p.run, p.slots, stream())
        smoke.check(err == 0, f"corr_backward_probe: launch failed: cudaError {err}")
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/corr_backward_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("corr_backward_probe: no CUDA device", file=sys.stderr)
        return 2
    from deep_sfm_revisited_tpu_torch.ops.cuda import local_corr

    card = smoke.phase_setup(local_corr)
    libs = build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kind, dtype, a in b2_compare._backward_cases(smoke.B2_MD, g):
        if kind == "b2":
            B, H, W, C = a[0].shape
        else:
            B, C, H, W = a[0].shape
        p = local_corr.backward_plan(B, C, H, W, smoke.B2_MD, dtype, kind == "warped")
        ms = {name: smoke.graph_ms(caller(lib, kind, a, p)) for name, lib in libs.items()}
        parts = {"sums": ms["base"] - ms["no_sums"], "atomics": ms["base"] - ms["no_atomics"],
                 "dout": ms["base"] - ms["no_dout"], "rest": ms["rest"]}
        rows.append({"kind": kind, "shape": [B, C, H, W], "dtype": str(dtype)[6:],
                     "mapping": p.key, "graph_ms": ms, "parts_ms": parts})
        smoke.log(f"corr_backward_probe {kind} {(B, C, H, W)} {str(dtype)[6:]} {p.key}: "
                  + ", ".join(f"{k} {v:.5f}" for k, v in ms.items()) + "; parts "
                  + ", ".join(f"{k} {v:.5f}" for k, v in parts.items()))
    summary = {"card": card, "levels": rows}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
