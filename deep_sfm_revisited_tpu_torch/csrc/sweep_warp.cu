// Kernel B1: bilinear gather for the plane-sweep cost volume and DICL's
// flow warp, written for Hopper (sm_90a).
//
// Replaces deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py::
// bilinear_sample_pallas (the Pallas TPU kernel; its semantics are
// ops/camera.py::bilinear_sample of the JAX package): sample an NHWC image
// at (x, y) pixel coordinates, align_corners=True, and give exactly zero
// where the PRE-clip (x, y) lies outside [0, W-1] x [0, H-1]. Taps,
// weights and the blend are float32; the result is stored in the image's
// dtype (float32 or bfloat16).
//
// What bounds it: device-memory bytes. At the PSNet shape (one 96x320x32
// bf16 feature map, 128 planes -> 3,932,160 queries) it writes ~252 MB of
// warped features and reads ~31 MB of f32 coordinates: ~283 MB, about
// 85 us at the H100's 3.35 TB/s. The feature map itself is ~2 MB and stays
// in the 50 MB L2, so the four taps of a query cost L2 hits, not HBM
// traffic.
//
// Design: one thread per (query, 16-byte channel chunk) -- for C = 32 that
// is 4 threads per query in bf16 and 8 in f32 -- so neighbouring threads
// read and write neighbouring 16-byte chunks and every store is a full,
// coalesced 16-byte vector. All four taps are read straight from the NHWC
// image (no TPU quad layout). The blend uses __fmul_rn/__fadd_rn, which
// forbid FMA contraction, so the result is bit-identical to the plain
// PyTorch version (ops/camera.py::bilinear_sample_plain of the port).
//
// A later change fuses the coordinate computation (K R K^-1, K t, plane
// depth) and the [ref | warped] concat into the layout the 3D
// convolution reads, so the coordinates and the separate concat pass
// leave device memory altogether.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// 16-byte chunk <-> floats, by bits, for each storage type.
struct F32 {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load16(const void* p, float* v) {
    uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static void store16(void* p, const float* v) {
    uint4 r;
    r.x = __float_as_uint(v[0]); r.y = __float_as_uint(v[1]);
    r.z = __float_as_uint(v[2]); r.w = __float_as_uint(v[3]);
    *reinterpret_cast<uint4*>(p) = r;
  }
  __device__ __forceinline__ static float load1(const void* p, int64_t i) {
    return __ldg(reinterpret_cast<const float*>(p) + i);
  }
  __device__ __forceinline__ static void store1(void* p, int64_t i, float v) {
    reinterpret_cast<float*>(p)[i] = v;
  }
};

struct BF16 {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static float lo(uint32_t w) { return __uint_as_float(w << 16); }
  __device__ __forceinline__ static float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
  __device__ __forceinline__ static uint32_t bits(float f) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  __device__ __forceinline__ static void load16(const void* p, float* v) {
    uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = lo(r.x); v[1] = hi(r.x); v[2] = lo(r.y); v[3] = hi(r.y);
    v[4] = lo(r.z); v[5] = hi(r.z); v[6] = lo(r.w); v[7] = hi(r.w);
  }
  __device__ __forceinline__ static void store16(void* p, const float* v) {
    uint4 r;
    r.x = bits(v[0]) | (bits(v[1]) << 16); r.y = bits(v[2]) | (bits(v[3]) << 16);
    r.z = bits(v[4]) | (bits(v[5]) << 16); r.w = bits(v[6]) | (bits(v[7]) << 16);
    *reinterpret_cast<uint4*>(p) = r;
  }
  __device__ __forceinline__ static float load1(const void* p, int64_t i) {
    unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p) + i);
    return __uint_as_float(((uint32_t)u) << 16);
  }
  __device__ __forceinline__ static void store1(void* p, int64_t i, float v) {
    reinterpret_cast<unsigned short*>(p)[i] = (unsigned short)bits(v);
  }
};

__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11,
                                       float wx, float ax, float wy, float ay,
                                       float valid) {
  // ((v00 (1-wx) + v01 wx) (1-wy) + (v10 (1-wx) + v11 wx) wy) * valid,
  // rounded op by op exactly as the plain version's separate tensor ops
  float top = __fadd_rn(__fmul_rn(v00, ax), __fmul_rn(v01, wx));
  float bot = __fadd_rn(__fmul_rn(v10, ax), __fmul_rn(v11, wx));
  return __fmul_rn(__fadd_rn(__fmul_rn(top, ay), __fmul_rn(bot, wy)), valid);
}

// VECTOR: each thread moves one 16-byte chunk (T::kVec channels) per tap;
// otherwise one channel. img (B,H,W,C), coords (B,Q,2), out (B,Q,C).
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(256)
bilinear_sample_kernel(const void* __restrict__ img,
                       const float2* __restrict__ coords,
                       void* __restrict__ out,
                       int B, int H, int W, int C, int64_t Q) {
  constexpr int kVec = VECTOR ? T::kVec : 1;
  const int tpq = C / kVec;  // threads per query
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)B * Q * tpq;
  if (tid >= total) return;
  const int64_t q = tid / tpq;                 // query in [0, B*Q)
  const int c0 = (int)(tid - q * tpq) * kVec;  // first channel
  const int b = (int)(q / Q);

  const float2 xy = __ldg(coords + q);
  float x = xy.x, y = xy.y;
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
  const float valid = (x >= 0.f && x <= wm1 && y >= 0.f && y <= hm1) ? 1.f : 0.f;
  x = fminf(fmaxf(x, 0.f), wm1);
  y = fminf(fmaxf(y, 0.f), hm1);
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx = __fsub_rn(x, x0), wy = __fsub_rn(y, y0);
  const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
  const int xi = min(max((int)x0, 0), W - 1);
  const int yi = min(max((int)y0, 0), H - 1);
  const int xi1 = min(xi + 1, W - 1), yi1 = min(yi + 1, H - 1);

  const int64_t base = (int64_t)b * H * W;
  const int64_t i00 = (base + (int64_t)yi * W + xi) * C + c0;
  const int64_t i01 = (base + (int64_t)yi * W + xi1) * C + c0;
  const int64_t i10 = (base + (int64_t)yi1 * W + xi) * C + c0;
  const int64_t i11 = (base + (int64_t)yi1 * W + xi1) * C + c0;
  const int64_t io = q * C + c0;
  constexpr int kBytes = VECTOR ? 16 / T::kVec : 0;  // bytes per element

  if constexpr (VECTOR) {
    const char* src = reinterpret_cast<const char*>(img);
    float v00[kVec], v01[kVec], v10[kVec], v11[kVec], r[kVec];
    T::load16(src + i00 * kBytes, v00);
    T::load16(src + i01 * kBytes, v01);
    T::load16(src + i10 * kBytes, v10);
    T::load16(src + i11 * kBytes, v11);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      r[k] = blend(v00[k], v01[k], v10[k], v11[k], wx, ax, wy, ay, valid);
    T::store16(reinterpret_cast<char*>(out) + io * kBytes, r);
  } else {
    const float v = blend(T::load1(img, i00), T::load1(img, i01),
                          T::load1(img, i10), T::load1(img, i11),
                          wx, ax, wy, ay, valid);
    T::store1(out, io, v);
  }
}

template <typename T, bool VECTOR>
cudaError_t launch(const void* img, const void* coords, void* out, int B,
                   int H, int W, int C, int64_t Q, cudaStream_t stream) {
  const int kVec = VECTOR ? T::kVec : 1;
  const int64_t total = (int64_t)B * Q * (C / kVec);
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bilinear_sample_kernel<T, VECTOR><<<(unsigned)blocks, threads, 0, stream>>>(
      img, reinterpret_cast<const float2*>(coords), out, B, H, W, C, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vector: 1 when C * itemsize is a
// multiple of 16 and img/out are 16-byte aligned (the wrapper checks).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dsfm_bilinear_sample(const void* img, const void* coords,
                                    void* out, int B, int H, int W, int C,
                                    long long Q, int dtype, int vector,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector ? launch<F32, true>(img, coords, out, B, H, W, C, Q, s)
                  : launch<F32, false>(img, coords, out, B, H, W, C, Q, s);
  if (dtype == 1)
    return vector ? launch<BF16, true>(img, coords, out, B, H, W, C, Q, s)
                  : launch<BF16, false>(img, coords, out, B, H, W, C, Q, s);
  return (int)cudaErrorInvalidValue;
}
