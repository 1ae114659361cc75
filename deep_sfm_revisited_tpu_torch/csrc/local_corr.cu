// Kernel B2: PWC-style windowed correlation, written for Hopper (sm_90a).
//
// Replaces deep_sfm_revisited_tpu/ops/pallas/local_corr.py::
// local_correlation_pallas (the Pallas TPU kernel; its semantics are
// ops/correlation.py::local_correlation of the JAX package):
//
//   out[b, y, x, (dy+md)(2md+1) + (dx+md)]
//       = (sum_c f0[b, y, x, c] * f1[b, y+dy, x+dx, c]) / C,
//
// zero where (y+dy, x+dx) lies outside the frame. f0, f1 (B, H, W, C) and
// out (B, H, W, (2md+1)^2) are float32 NHWC, written directly in that
// layout (the TPU kernel's displacement-major output and its moveaxis
// existed only for Mosaic).
//
// What bounds it on an H100 SXM: device-memory bytes. At PWC-DC's five
// levels on a 384x1280 pair (C = 196, 128, 96, 64, 32, md = 4) one pair
// reads f0 and f1 once and writes the 81-channel volume once: ~27 MB, about
// 8 us at 3.35 TB/s; level 2 alone is 17.8 MB. The arithmetic is ~282
// MFLOP, about 4 us at 67 TFLOP/s float32. At the fine levels the output
// outweighs the inputs (81 channels out against 2 x 32 in at level 2), so
// the writes dominate the bytes.
//
// Design (a simple, correct first form):
//   * a block of 128 threads covers a 4 x 32 tile of output pixels of one
//     image, one thread per pixel (a warp is one tile row, so its shared
//     memory reads are conflict-free);
//   * channels go in chunks of 16: the block stages the f0 tile and the f1
//     halo (tile + md on every side) of the chunk in shared memory,
//     channel-major, writing zeros for halo pixels outside the frame -- so
//     the frame border costs nothing in the inner loop and there is no
//     padded copy of f1 in device memory (the TPU wrapper's jnp.pad);
//   * each thread keeps its pixel's (2md+1)^2 sums in float32 registers
//     (md is a template parameter, so the window loop unrolls) and divides
//     by C once at the end;
//   * the sums go through shared memory once more, so that each image row
//     of the tile is written to device memory as one contiguous, coalesced
//     run of 32 * 81 floats.
// The halo is read from L2 (neighbouring tiles share it), so device memory
// sees each input byte about once. What a faster form would change: more
// pixels per thread (reusing each f1 value across dx in registers) and
// asynchronous copies of the next chunk behind the current one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 4;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;
constexpr int kChunk = 16;  // channels staged per pass

template <int MD>
struct Geometry {
  static constexpr int S = 2 * MD + 1;
  static constexpr int S2 = S * S;
  static constexpr int HaloH = kTileH + 2 * MD;
  static constexpr int HaloW = kTileW + 2 * MD;
  // +1: channel planes start on different banks when the halo is staged
  static constexpr int HaloStride = HaloH * HaloW + 1;
  static constexpr int F0Stride = kThreads + 1;
  static constexpr int StageFloats = kChunk * (HaloStride + F0Stride);
  static constexpr int OutFloats = kThreads * S2;
  static constexpr int SmemFloats = StageFloats > OutFloats ? StageFloats : OutFloats;
};

template <int MD>
__global__ void __launch_bounds__(kThreads)
local_corr_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                  float* __restrict__ out, int H, int W, int C) {
  using G = Geometry<MD>;
  extern __shared__ float smem[];
  float* f1s = smem;                             // [kChunk][HaloStride]
  float* f0s = smem + kChunk * G::HaloStride;    // [kChunk][F0Stride]

  const int tid = threadIdx.x;
  const int tx = tid % kTileW, ty = tid / kTileW;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const int64_t img = (int64_t)b * H * W;

  float acc[G::S2];
#pragma unroll
  for (int k = 0; k < G::S2; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int nc = min(kChunk, C - c0);
    __syncthreads();  // the previous chunk's reads are done
    // f1 halo, channel fastest in device memory, channel-major here
    for (int i = tid; i < G::HaloH * G::HaloW * nc; i += kThreads) {
      const int px = i / nc, c = i - px * nc;
      const int gy = y0 - MD + px / G::HaloW, gx = x0 - MD + px % G::HaloW;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg(f1 + (img + (int64_t)gy * W + gx) * C + c0 + c);
      f1s[c * G::HaloStride + px] = v;
    }
    for (int i = tid; i < kThreads * nc; i += kThreads) {
      const int px = i / nc, c = i - px * nc;
      const int gy = y0 + px / kTileW, gx = x0 + px % kTileW;
      float v = 0.f;
      if (gy < H && gx < W) v = __ldg(f0 + (img + (int64_t)gy * W + gx) * C + c0 + c);
      f0s[c * G::F0Stride + px] = v;
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const float a = f0s[c * G::F0Stride + tid];
      const float* win = f1s + c * G::HaloStride + ty * G::HaloW + tx;
#pragma unroll
      for (int dy = 0; dy < G::S; ++dy)
#pragma unroll
        for (int dx = 0; dx < G::S; ++dx)
          acc[dy * G::S + dx] = fmaf(a, win[dy * G::HaloW + dx], acc[dy * G::S + dx]);
    }
  }

  // stage the tile's sums (thread-major; S2 is odd, so conflict-free) and
  // write each tile row as one contiguous run
  __syncthreads();
  const float cf = (float)C;
#pragma unroll
  for (int k = 0; k < G::S2; ++k) smem[tid * G::S2 + k] = acc[k] / cf;
  __syncthreads();
  const int nx = min(kTileW, W - x0);
  for (int r = 0; r < kTileH; ++r) {
    const int y = y0 + r;
    if (y >= H) break;
    float* dst = out + (img + (int64_t)y * W + x0) * G::S2;
    const float* src = smem + r * kTileW * G::S2;
    for (int i = tid; i < nx * G::S2; i += kThreads) dst[i] = src[i];
  }
}

template <int MD>
cudaError_t launch(const float* f0, const float* f1, float* out, int B, int H,
                   int W, int C, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Geometry<MD>::SmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      local_corr_kernel<MD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  local_corr_kernel<MD><<<grid, kThreads, smem, stream>>>(f0, f1, out, H, W, C);
  return cudaGetLastError();
}

}  // namespace

// f0, f1 (B, H, W, C) float32 contiguous; out (B, H, W, (2md+1)^2) float32.
// md in 1..4. Returns the cudaError_t of the launch (0 on success).
extern "C" int dsfm_local_correlation(const void* f0, const void* f1, void* out,
                                      int B, int H, int W, int C, int md,
                                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* a = reinterpret_cast<const float*>(f0);
  const float* b = reinterpret_cast<const float*>(f1);
  float* o = reinterpret_cast<float*>(out);
  switch (md) {
    case 1: return launch<1>(a, b, o, B, H, W, C, s);
    case 2: return launch<2>(a, b, o, B, H, W, C, s);
    case 3: return launch<3>(a, b, o, B, H, W, C, s);
    case 4: return launch<4>(a, b, o, B, H, W, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
