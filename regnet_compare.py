#!/usr/bin/env python3
"""Where REGNet's sweep-correlation kernels K1 and K2 spend their time, on one card.

    python3 regnet_compare.py [--out regnet_compare.json]     # needs one CUDA device

Builds variants of `csrc/sweep_corr.cu` (in parallel, one nvcc each) and
times each beside the unchanged source by CUDA events around its launch,
in the order listed and back, on random bf16 features of REGNet's shape
(C = 32 at a quarter of the image), its 128 planes and the 125 poses of
`models/depth_alternates.py::sample_pose_grid` around a forward KITTI
pose: K1 at an eval pair (b = 1, 384x1280) and at a training step (b = 4,
256x768), K2 at the training step.

- `k1_lanes`: K1 with a sample's C / 8 lanes reading a 16-byte chunk of
  each tap each (every lane computing the sample's point), the lanes'
  partial sums added by shuffles: a warp's tap loads reach 8 cache lines,
  not 32 (its channel order differs from the plain version's);
- `k2_direct`: every sample adds its four taps to device memory with
  16-byte vector reductions (the box cap set to 0): the simple form of
  the backward, without the shared-memory box accumulator;
- `k2_planes16`, `k2_planes64`: groups of 16 and 64 planes instead of 32;
- one part switched off, for timing only (the outputs are wrong by
  design): `k2_no_dref` (d ref's gathers and blends), `k2_no_smem` (the
  shared-memory atomics of the box accumulator).

It also times REGNet's first 3D convolution (`posecnn0`'s Conv3d: 125
poses in, 32 channels out, 3x3x3, bf16 with channels-last-3d strides, as
the net runs it under autocast) beside the same convolution on the input
padded to 128 channels (zeros, timing only: the port does not pad), at an
eval pair's volume (forward) and a training step's (forward and backward),
by CUDA events in turns: cuDNN's kernels may like 125 channels less than a
multiple of 8.

Each variant is found by fixed pieces of the source: update them when
those lines change. Nothing here is held to a plain version
(`chip_smoke.py` phase 33 does that). Prints the card line, one line a
kernel and, as the last line, one JSON object; writes the same object to
--out.
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

K1_START, K1_END = "// K1. Thread i is sample", "// K2. g (B, D, H, W, S) float32"
K1_LANES = """// K1 with a sample's lanes a 16-byte chunk each.
template <typename T>
__global__ void __launch_bounds__(kCorrThreads)
sweep_correlation_kernel(const void* __restrict__ ref, const void* __restrict__ tgt,
                         const float* __restrict__ depths, const float* __restrict__ M,
                         const float* __restrict__ Kt, float* __restrict__ out, int S, int D,
                         int H, int W, int C, int64_t total) {
  constexpr int kVec = T::kVec, kBytes = 16 / kVec;
  const int tpp = C / kVec;
  const int j = threadIdx.x & (tpp - 1);
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / tpp;
  const bool live = i < total;
  int64_t r = live ? i : total - 1;
  const int s = (int)(r % S); r /= S;
  const int x = (int)(r % W); r /= W;
  const int y = (int)(r % H); r /= H;
  const int d = (int)(r % D);
  const int b = (int)(r / D);
  const SweepRay ray(M, Kt, b * S + s, x, y);
  const Taps t = ray.taps(__ldg(depths + d), H, W);
  float part = 0.f;
  if (t.valid != 0.f) {
    const int64_t pixel = ((int64_t)b * H + y) * W + x;
    const char* img = reinterpret_cast<const char*>(tgt) + (int64_t)b * H * W * C * kBytes;
    float w[kVec], rv[kVec];
    sample16<T>(img, t, C, j * kVec, w);
    T::load16(reinterpret_cast<const char*>(ref) + (pixel * C + j * kVec) * kBytes, rv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) part = __fadd_rn(part, __fmul_rn(rv[k], w[k]));
  }
  float acc = part;
  for (int l = 1; l < tpp; ++l) acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, part, l, tpp));
  if (live && j == 0) out[i] = __fdiv_rn(acc, (float)C);
}

template <typename T>
cudaError_t launch_forward(const void* ref, const void* tgt, const float* depths,
                           const float* M, const float* Kt, float* out, int B, int S, int D,
                           int H, int W, int C, cudaStream_t stream) {
  const int tpp = C / T::kVec;
  const int64_t total = (int64_t)B * S * D * H * W;
  const int64_t blocks = (total * tpp + kCorrThreads - 1) / kCorrThreads;
  sweep_correlation_kernel<T><<<(unsigned)blocks, kCorrThreads, 0, stream>>>(
      ref, tgt, depths, M, Kt, out, S, D, H, W, C, total);
  return cudaGetLastError();
}

"""
PLANES = "constexpr int kBwdPlanes = 32;"
CAP = "kBwdSmemBytes / (C * 4));"
DREF = "          sample16<T>(img, t, C, c0, w);\n"
SMEM = "              atomicAdd(acc + smem_slot(q{0}, c0 + k, C), __fmul_rn(gv[k], w{0}));\n"


def variants(src: str) -> dict:
    """{name: source} of the variants."""
    def once(text):
        smoke.check(src.count(text) == 1, f"regnet_compare: not found once: {text[:60]!r}")
        return text

    no_smem = src
    for q in ("00", "01", "10", "11"):
        no_smem = no_smem.replace(once(SMEM.format(q)), f"              if (gv[k] == 1.2345e-30f) "
                                  f"acc[q{q}] = w{q};\n")
    a, b = src.index(once(K1_START)), src.index(once(K1_END))
    return {
        "k1_lanes": src[:a] + K1_LANES + src[b:],
        "k2_direct": src.replace(once(CAP), "0);"),
        "k2_planes16": src.replace(once(PLANES), PLANES.replace("32", "16")),
        "k2_planes64": src.replace(once(PLANES), PLANES.replace("32", "64")),
        "k2_no_dref": src.replace(once(DREF), "          for (int k = 0; k < kVec; ++k) "
                                              "w[k] = t.wx;\n"),
        "k2_no_smem": no_smem,
    }


def build(name: str, text: str, build_dir: Path):
    """A variant's library, built by `ops/cuda/build.py` from a copy of the
    source in `build_dir`, with the launchers' argument types bound."""
    from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel

    path = build_dir / f"sweep_corr_{name}.cu"
    path.write_text(text)
    P, I = ctypes.c_void_p, ctypes.c_int

    class Variant(CudaKernel):
        source = str(path.resolve())   # an absolute path replaces csrc/

        def _bind(self, lib):
            lib.dsfm_sweep_correlation.argtypes = [P] * 6 + [I] * 7 + [P]
            lib.dsfm_sweep_correlation.restype = I
            lib.dsfm_sweep_correlation_backward.argtypes = [P] * 8 + [I] * 7 + [P]
            lib.dsfm_sweep_correlation_backward.restype = I

    return Variant().build()


def inputs(B, H, W, seed=0):
    """REGNet's K1 inputs at a quarter of a B x H x W batch: bf16 features,
    128 plane depths, M and K t of 125 poses a batch item; and a gradient."""
    from deep_sfm_revisited_tpu_torch.models import depth_alternates as da
    from deep_sfm_revisited_tpu_torch.ops import camera

    g = torch.Generator(device="cuda").manual_seed(seed)
    h, w = H // 4, W // 4
    ref = torch.randn(B, h, w, 32, device="cuda", generator=g).bfloat16()
    tgt = torch.randn(B, h, w, 32, device="cuda", generator=g).bfloat16()
    K = torch.tensor(smoke.K_KITTI, device="cuda") * torch.tensor([[0.25], [0.25], [1.0]],
                                                                  device="cuda")
    K = K.expand(B, 3, 3)
    pose = torch.tensor([[1.0, 0, 0, 0.02], [0, 1, 0, 0.01], [0, 0, 1, 0.99]],
                        device="cuda").expand(B, 3, 4)
    poses = da.sample_pose_grid(pose, 5, 0.12, 0.27)
    S = poses.shape[1]
    M, Kt = camera.sweep_matrices(poses.reshape(B * S, 3, 4), K.repeat_interleave(S, 0),
                                  torch.linalg.inv(K).repeat_interleave(S, 0))
    depths = 128.0 / torch.arange(1, 129, dtype=torch.float32, device="cuda")
    grad = 1e-3 * torch.randn(B, S, 128, h, w, device="cuda", generator=g)
    return ref, tgt, depths, M, Kt, grad.contiguous(memory_format=torch.channels_last_3d)


def posecnn0_conv(summary: dict) -> None:
    """posecnn0's Conv3d on 125 channels against 128, in turns (see the
    module's docstring); adds `posecnn0_events_ms` to the summary's cells."""
    for tag, (B, H, W) in (("eval_pair", (1, 384, 1280)), ("train_step", (4, 256, 768))):
        times = {}
        for cin in (125, 128):
            g = torch.Generator(device="cuda").manual_seed(cin)
            conv = torch.nn.Conv3d(cin, 32, 3, 1, 1, bias=False).cuda().to(
                torch.bfloat16, memory_format=torch.channels_last_3d)
            x = torch.randn(B, cin, 128, H // 4, W // 4, device="cuda", generator=g,
                            dtype=torch.bfloat16).contiguous(
                memory_format=torch.channels_last_3d)
            if tag == "train_step":
                x.requires_grad_()
                dy = torch.randn_like(conv(x))

                def run(conv=conv, x=x, dy=dy):
                    conv(x).backward(dy)
            else:
                def run(conv=conv, x=x):
                    with torch.no_grad():
                        conv(x)
            times[f"cin{cin}"] = run
        ms = {k: [] for k in times}
        for k in list(times) + list(times)[::-1]:   # in turns
            ms[k].append(smoke.cuda_ms(times[k], reps=3))
        summary[tag]["posecnn0_events_ms"] = ms
        smoke.log(f"regnet_compare {tag} posecnn0 Conv3d "
                  + ("forward and backward" if tag == "train_step" else "forward") + ": "
                  + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in ms.items())
                  + " ms by events")


def compare() -> dict:
    from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_corr
    from deep_sfm_revisited_tpu_torch.ops.cuda.build import BUILD_DIR

    card = smoke.phase_setup(sweep_corr)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = (Path(sweep_corr.__file__).parents[2] / "csrc" / "sweep_corr.cu").read_text()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:   # one nvcc a variant
        futures = {name: pool.submit(build, name, text, BUILD_DIR)
                   for name, text in variants(src).items()}
        libs = {name: f.result() for name, f in futures.items()}
    smoke.log(f"regnet_compare: {len(libs)} variants built in {time.perf_counter() - t0:.1f} s")
    summary = {"card": card}
    for tag, (B, H, W) in (("eval_pair", (1, 384, 1280)), ("train_step", (4, 256, 768))):
        ref, tgt, depths, M, Kt, grad = inputs(B, H, W)
        args = (ref, tgt, depths, M, Kt)
        h, w, C = ref.shape[1:]
        S = M.shape[0] // B
        out = torch.empty(B, S, 128, h, w, device="cuda")

        def k1_lanes(lib=libs["k1_lanes"]):
            err = lib.dsfm_sweep_correlation(ref.data_ptr(), tgt.data_ptr(), depths.data_ptr(),
                                             M.data_ptr(), Kt.data_ptr(), out.data_ptr(), B, S,
                                             128, h, w, C, 1,
                                             torch.cuda.current_stream().cuda_stream)
            smoke.check(err == 0, f"regnet_compare: k1_lanes launch failed: cudaError {err}")

        k1 = {"k1": lambda: sweep_corr.sweep_correlation_cuda(*args), "k1_lanes": k1_lanes}
        k1_ms = {k: [] for k in k1}
        for k in list(k1) + list(k1)[::-1]:
            k1_ms[k].append(smoke.cuda_ms(k1[k], reps=5))
        summary[tag] = {"shape": [B, H, W], "k1_events_ms": k1_ms}
        smoke.log(f"regnet_compare {tag}: " + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}"
                                                        for k, v in k1_ms.items())
                  + " ms by events")
        if tag != "train_step":
            continue
        runs = {"k2": lambda: sweep_corr.sweep_correlation_backward_cuda(grad, *args)}
        dref = torch.empty_like(ref)
        acc = torch.zeros(B, h, w, C, device="cuda")
        for name, lib in libs.items():
            if not name.startswith("k2"):
                continue

            def run(lib=lib, name=name):
                acc.zero_()
                err = lib.dsfm_sweep_correlation_backward(
                    grad.data_ptr(), ref.data_ptr(), tgt.data_ptr(), depths.data_ptr(),
                    M.data_ptr(), Kt.data_ptr(), dref.data_ptr(), acc.data_ptr(), B,
                    M.shape[0] // B, depths.shape[0], h, w, C, 1,
                    torch.cuda.current_stream().cuda_stream)
                smoke.check(err == 0, f"regnet_compare: {name} launch failed: cudaError {err}")
            runs[name] = run
        times = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:   # in the order listed and back
            times[k].append(smoke.cuda_ms(runs[k], reps=2, warmup=1))
        summary[tag]["k2_events_ms"] = times
        smoke.log(f"regnet_compare {tag} K2: "
                  + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in times.items()) + " ms")
    posecnn0_conv(summary)
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("regnet_compare: no CUDA device", file=sys.stderr)
        return 2
    line = json.dumps(compare())
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
