// Kernels K1 and K2: REGNet's sweep correlation and its backward, written for
// Hopper (sm_90a).
//
// K1, dsfm_sweep_correlation -- B1's gather (deep_sfm_revisited_tpu/ops/
// pallas/sweep_warp.py::bilinear_sample_pallas, pallas_call at :145) as the
// JAX package's REGNet reaches it: XLA's bilinear_sample under
// plane_sweep_warp (JAX ops/camera.py:198-208), with REGNet's S pose
// hypotheses folded into the batch (models/depth_alternates.py:91-107),
// fused with REGNet's channel mean, corr = mean(ref * warped, -1)
// (:248-252). ref, tgt (B, H, W, C) in float32 or bfloat16; depths (D,);
// M = K R K^-1 (B S, 3, 3) and K t (B S, 3) of every (batch item, pose).
// Output (B, D, H, W, S) float32: the memory order of JAX's
// moveaxis(corr, 1, -1), which the (B, S, D, H, W) tensor with
// channels-last-3d strides that REGNet's first Conv3d reads has.
// Materialised, the warped stack would not fit on the card: an eval pair
// warps 125 poses x 128 planes x 96 x 320 pixels x 32 channels, 63 GB in
// float32; only the 1.97 GB correlation is written here.
// Each sample's taps come from SweepRay (sweep.cuh): the sweep kernel's point,
// divide and rule, rounded op by op as ops/camera.py::sweep_pixel_coords;
// the blend is bilinear.cuh's, with no FMA contraction; the channel sum runs
// c = 0..C-1 in order, a product and a sum rounded apart, then one divide
// by C. ops/camera.py::sweep_correlation_plain does the same in the same
// order, so the two agree bit for bit (up to the sign of a zero).
// What bounds it: float32 arithmetic, ~12 operations a channel of a valid
// sample (the blend's 10, the product, the sum): at an eval pair 491.5 M
// samples x 32 channels, ~133 GFLOP at its ~68% valid samples, ~2.0 ms at
// 67 TFLOP/s, against 1.97 GB of output, 0.59 ms at 3.35 TB/s. The mapping
// is the simple one: a thread a sample (b, d, y, x, s), s fastest, so a
// warp's stores are one contiguous run and its lanes share the ref pixel
// (one broadcast load from L1); the feature maps are 2-4 MB, so every tap
// hits L2 or L1. What paces it is the instructions a sample issues, its
// point and two IEEE divisions among them (regnet_compare.py): a mapping
// with a sample's C / kVec lanes reading a 16-byte chunk each, every lane
// computing the sample's point, ran 1.6-1.9x slower.
//
// K2, dsfm_sweep_correlation_backward -- its gradient with respect to ref and
// tgt, for training REGNet (it replaces the gradient XLA derives for the JAX
// composition: there is no TPU kernel behind it). With gc = g / C for the
// incoming gradient g (B, D, H, W, S) float32:
//   dref[p, c] = sum over (s, d) of gc warped_c,
//   dtgt[q, c] = sum over the samples that tap q of gc ref[p, c] w_tap.
// It is the sweep backward's design (sweep_warp.cu) with the warped
// half's gradient formed on the fly as gc ref[p, :]: a block owns a tile of
// ref pixels of one batch item (thread k of a pixel owns channel chunk k, its
// ref chunk in registers) and walks groups of planes, and in each group
// every pose; per (group, pose) its first warp bounds the taps by the
// group's box (group_box, sweep.cuh), the block adds every valid sample's
// four weighted taps into a float32 box accumulator in shared memory with
// shared atomics and flushes it to dtgt with 16-byte vector reductions; a
// group whose box is too large, and a sample whose taps leave the box, add
// to dtgt directly. dref is summed in registers in a fixed order (group,
// pose, plane), so it is the same every launch; dtgt's atomics are not.
// What bounds it: float32 arithmetic, ~21 operations a channel of a valid
// sample (the blend, dref's product and sum, the ref product, four taps'
// products and sums), ~2x K1's; the shared-memory atomics (float atomics in
// shared memory are compare-and-swap loops on this card) set its pace: at a
// b = 4 training step up to 786 M samples x 4 taps x 32 channels are 1e11
// adds (regnet_compare.py, on random features: without them the kernel
// takes about a quarter of its time; every sample straight to device memory
// by 16-byte reductions, without the box, takes 15-22% more; groups of 16
// planes take ~5% more than 32, groups of 64 ~10% less, but a larger group
// has a larger box, which sends more groups down the direct path on a real
// scene's poses, where it is untimed).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bilinear.cuh"   // Taps, blend
#include "sweep.cuh"      // SweepRay, GroupBox, group_box, smem_slot, red16

namespace {

constexpr int kCorrThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kBwdThreads = 256;          // the most threads a block may have
constexpr int kBwdPlanes = 32;            // planes of a group (16 and 64: regnet_compare.py)
constexpr int kBwdSmemBytes = 64 * 1024;  // the box accumulator: 512 pixels at C = 32

// 16 bytes of features as floats, by bits, for each storage type.
struct F32 {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load16(const void* p, float* v) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack16(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

struct BF16 {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static uint32_t bits(float f) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  __device__ __forceinline__ static void load16(const void* p, float* v) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack16(const float* v) {
    return make_uint4(bits(v[0]) | (bits(v[1]) << 16), bits(v[2]) | (bits(v[3]) << 16),
                      bits(v[4]) | (bits(v[5]) << 16), bits(v[6]) | (bits(v[7]) << 16));
  }
};

// Channels c0 .. c0 + kVec of the sample at taps t of the NHWC map `img`
// (one batch item), blended into w.
template <typename T>
__device__ __forceinline__ void sample16(const char* img, const Taps& t, int C, int c0,
                                         float* w) {
  constexpr int kVec = T::kVec, kBytes = 16 / kVec;
  float v00[kVec], v01[kVec], v10[kVec], v11[kVec];
  T::load16(img + (t.i00 * C + c0) * kBytes, v00);
  T::load16(img + (t.i01 * C + c0) * kBytes, v01);
  T::load16(img + (t.i10 * C + c0) * kBytes, v10);
  T::load16(img + (t.i11 * C + c0) * kBytes, v11);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    w[k] = blend(v00[k], v01[k], v10[k], v11[k], t.wx, t.ax, t.wy, t.ay, t.valid);
}

// K1. Thread i is sample ((((b D + d) H + y) W + x) S + s), the index of its
// output; M and Kt are indexed by b S + s.
template <typename T>
__global__ void __launch_bounds__(kCorrThreads)
sweep_correlation_kernel(const void* __restrict__ ref, const void* __restrict__ tgt,
                         const float* __restrict__ depths, const float* __restrict__ M,
                         const float* __restrict__ Kt, float* __restrict__ out, int S, int D,
                         int H, int W, int C, int64_t total) {
  constexpr int kVec = T::kVec, kBytes = 16 / kVec;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int64_t r = i;
  const int s = (int)(r % S); r /= S;
  const int x = (int)(r % W); r /= W;
  const int y = (int)(r % H); r /= H;
  const int d = (int)(r % D);
  const int b = (int)(r / D);
  const SweepRay ray(M, Kt, b * S + s, x, y);
  const Taps t = ray.taps(__ldg(depths + d), H, W);
  float acc = 0.f;
  if (t.valid != 0.f) {   // an invalid sample's products are all (+-)0
    const int64_t pixel = ((int64_t)b * H + y) * W + x;
    const char* rp = reinterpret_cast<const char*>(ref) + pixel * C * kBytes;
    const char* img = reinterpret_cast<const char*>(tgt) + (int64_t)b * H * W * C * kBytes;
    for (int c0 = 0; c0 < C; c0 += kVec) {
      float w[kVec], rv[kVec];
      sample16<T>(img, t, C, c0, w);
      T::load16(rp + c0 * kBytes, rv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc = __fadd_rn(acc, __fmul_rn(rv[k], w[k]));
    }
  }
  out[i] = __fdiv_rn(acc, (float)C);
}

template <typename T>
cudaError_t launch_forward(const void* ref, const void* tgt, const float* depths,
                           const float* M, const float* Kt, float* out, int B, int S, int D,
                           int H, int W, int C, cudaStream_t stream) {
  const int64_t total = (int64_t)B * S * D * H * W;
  const int64_t blocks = (total + kCorrThreads - 1) / kCorrThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  sweep_correlation_kernel<T><<<(unsigned)blocks, kCorrThreads, 0, stream>>>(
      ref, tgt, depths, M, Kt, out, S, D, H, W, C, total);
  return cudaGetLastError();
}

// K2. g (B, D, H, W, S) float32; ref, tgt (B, H, W, C) in T; dref (B, H, W,
// C) in T; dtgt (B, H, W, C) float32, zeroed by the caller. Block = ((b
// tiles_y) + ty) tiles_x + tx owns a tile_h x tile_w tile of ref pixels of
// batch item b, `tpp` threads a pixel; it walks the planes in groups of
// kBwdPlanes and, in each group, every pose s: the group's box for (b, s),
// the samples into the box accumulator (or to dtgt directly), the flush.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
sweep_correlation_backward_kernel(const float* __restrict__ g, const void* __restrict__ ref,
                                  const void* __restrict__ tgt,
                                  const float* __restrict__ depths,
                                  const float* __restrict__ M, const float* __restrict__ Kt,
                                  void* __restrict__ dref, float* __restrict__ dtgt, int S,
                                  int D, int H, int W, int C, int tile_h, int tile_w,
                                  int tiles_x, int tiles_y, int cap) {
  extern __shared__ float4 acc4[];
  float* const acc = reinterpret_cast<float*>(acc4);
  __shared__ GroupBox box;
  constexpr int kVec = T::kVec, kBytes = 16 / kVec;
  const int tpp = C / kVec;
  const int pix = threadIdx.x / tpp;
  const int c0 = (threadIdx.x - pix * tpp) * kVec;
  int r = blockIdx.x;
  const int tx0 = (r % tiles_x) * tile_w;
  r /= tiles_x;
  const int ty0 = (r % tiles_y) * tile_h;
  const int b = r / tiles_y;
  const int tx1 = min(tx0 + tile_w, W) - 1, ty1 = min(ty0 + tile_h, H) - 1;
  const int x = tx0 + pix % tile_w, y = ty0 + pix / tile_w;
  const bool in = x <= tx1 && y <= ty1;

  const int64_t pixel = ((int64_t)b * H + (in ? y : ty0)) * W + (in ? x : tx0);
  float rv[kVec], rsum[kVec];
  T::load16(reinterpret_cast<const char*>(ref) + (pixel * C + c0) * kBytes, rv);
#pragma unroll
  for (int k = 0; k < kVec; ++k) rsum[k] = 0.f;
  const char* img = reinterpret_cast<const char*>(tgt) + (int64_t)b * H * W * C * kBytes;
  float* const gacc = dtgt + (int64_t)b * H * W * C + c0;
  const float fc = (float)C;
  const int64_t plane = (int64_t)H * W * S;      // g's stride from plane to plane
  const float* const gp = g + (((int64_t)b * D * H + y) * W + x) * S;

  for (int d0 = 0; d0 < D; d0 += kBwdPlanes) {
    const int d1 = min(D, d0 + kBwdPlanes);
    for (int s = 0; s < S; ++s) {
      const int bs = b * S + s;
      if (threadIdx.x < 32) {
        const GroupBox gb = group_box(depths, M, Kt, bs, d0, d1, tx0, ty0, tx1, ty1, H, W, cap,
                                      threadIdx.x);
        if (threadIdx.x == 0) box = gb;
      }
      __syncthreads();
      const GroupBox gb = box;
      const int n4 = gb.w * gb.h * C / 4;
      for (int i = threadIdx.x; i < n4; i += blockDim.x) acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();

      if (in) {
        const SweepRay ray(M, Kt, bs, x, y);
        for (int d = d0; d < d1; ++d) {
          const Taps t = ray.taps(__ldg(depths + d), H, W);
          if (t.valid == 0.f) continue;
          const float gc = __fdiv_rn(__ldg(gp + d * plane + s), fc);
          float w[kVec], gv[kVec];
          sample16<T>(img, t, C, c0, w);
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            rsum[k] = __fadd_rn(rsum[k], __fmul_rn(gc, w[k]));
            gv[k] = __fmul_rn(gc, rv[k]);
          }
          const float w00 = __fmul_rn(t.ay, t.ax), w01 = __fmul_rn(t.ay, t.wx);
          const float w10 = __fmul_rn(t.wy, t.ax), w11 = __fmul_rn(t.wy, t.wx);
          if (t.xi >= gb.x0 && t.xi1 < gb.x0 + gb.w && t.yi >= gb.y0 && t.yi1 < gb.y0 + gb.h) {
            const int q00 = (t.yi - gb.y0) * gb.w + (t.xi - gb.x0);
            const int q01 = q00 + (t.xi1 - t.xi), q10 = q00 + (t.yi1 - t.yi) * gb.w;
            const int q11 = q10 + (t.xi1 - t.xi);
#pragma unroll
            for (int k = 0; k < kVec; ++k) {
              atomicAdd(acc + smem_slot(q00, c0 + k, C), __fmul_rn(gv[k], w00));
              atomicAdd(acc + smem_slot(q01, c0 + k, C), __fmul_rn(gv[k], w01));
              atomicAdd(acc + smem_slot(q10, c0 + k, C), __fmul_rn(gv[k], w10));
              atomicAdd(acc + smem_slot(q11, c0 + k, C), __fmul_rn(gv[k], w11));
            }
          } else {
            red16<kVec>(gacc + t.i00 * C, gv, w00);
            red16<kVec>(gacc + t.i01 * C, gv, w01);
            red16<kVec>(gacc + t.i10 * C, gv, w10);
            red16<kVec>(gacc + t.i11 * C, gv, w11);
          }
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < n4; i += blockDim.x) {
        const int q = i / (C / 4), c = (i - q * (C / 4)) * 4;
        const float4 v = make_float4(acc[smem_slot(q, c, C)], acc[smem_slot(q, c + 1, C)],
                                     acc[smem_slot(q, c + 2, C)], acc[smem_slot(q, c + 3, C)]);
        const int yy = gb.y0 + q / gb.w, xx = gb.x0 + q % gb.w;
        atomicAdd(reinterpret_cast<float4*>(dtgt + ((((int64_t)b * H + yy) * W + xx) * C + c)),
                  v);
      }
      __syncthreads();
    }
  }
  if (in)
    *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dref) + (pixel * C + c0) * kBytes) =
        T::pack16(rsum);
}

// The tile: about 256 threads, as square as a power-of-two width allows
// (8 x 8 pixels at 4 threads a pixel), as the sweep backward's default.
__host__ inline void backward_tile(int tpp, int* tile_h, int* tile_w) {
  const int ppt = kBwdThreads / tpp > 0 ? kBwdThreads / tpp : 1;
  int w = 1;
  while (w * w < ppt) w *= 2;
  *tile_w = w < ppt ? w : ppt;
  *tile_h = ppt / *tile_w;
}

template <typename T>
cudaError_t launch_backward(const float* g, const void* ref, const void* tgt,
                            const float* depths, const float* M, const float* Kt, void* dref,
                            float* dtgt, int B, int S, int D, int H, int W, int C,
                            cudaStream_t stream) {
  static bool opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {   // the 64 KB accumulator is above the 48 KB default
    err = cudaFuncSetAttribute(sweep_correlation_backward_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  int tile_h = 0, tile_w = 0;
  backward_tile(C / T::kVec, &tile_h, &tile_w);
  const int threads = tile_h * tile_w * (C / T::kVec);
  if (threads < 32 || threads > kBwdThreads) return cudaErrorInvalidConfiguration;
  const int tiles_x = (W + tile_w - 1) / tile_w, tiles_y = (H + tile_h - 1) / tile_h;
  const int64_t blocks = (int64_t)B * tiles_y * tiles_x;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  sweep_correlation_backward_kernel<T><<<(unsigned)blocks, (unsigned)threads, kBwdSmemBytes,
                                         stream>>>(
      g, ref, tgt, depths, M, Kt, dref, dtgt, S, D, H, W, C, tile_h, tile_w, tiles_x, tiles_y,
      kBwdSmemBytes / (C * 4));
  return cudaGetLastError();
}

}  // namespace

// ref, tgt (B, H, W, C) contiguous (dtype 0: float32, 1: bfloat16), C * the
// element size a multiple of 16 bytes; depths (D,), M (B S, 3, 3), Kt (B S,
// 3) float32; out (B, D, H, W, S) float32.
extern "C" int dsfm_sweep_correlation(const void* ref, const void* tgt, const void* depths,
                                      const void* M, const void* Kt, void* out, int B, int S,
                                      int D, int H, int W, int C, int dtype, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(depths);
  const float* mp = static_cast<const float*>(M);
  const float* kp = static_cast<const float*>(Kt);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_forward<F32>(ref, tgt, dp, mp, kp, o, B, S, D, H, W, C, st);
  if (dtype == 1) return launch_forward<BF16>(ref, tgt, dp, mp, kp, o, B, S, D, H, W, C, st);
  return (int)cudaErrorInvalidValue;
}

// g (B, D, H, W, S) float32; ref, tgt, depths, M, Kt as the forward took
// them; dref (B, H, W, C) in the features' dtype; dtgt (B, H, W, C) float32,
// zeroed by the caller (the operator casts it for bfloat16 features).
extern "C" int dsfm_sweep_correlation_backward(const void* g, const void* ref, const void* tgt,
                                               const void* depths, const void* M,
                                               const void* Kt, void* dref, void* dtgt, int B,
                                               int S, int D, int H, int W, int C, int dtype,
                                               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* dp = static_cast<const float*>(depths);
  const float* mp = static_cast<const float*>(M);
  const float* kp = static_cast<const float*>(Kt);
  float* acc = static_cast<float*>(dtgt);
  if (dtype == 0)
    return launch_backward<F32>(gp, ref, tgt, dp, mp, kp, dref, acc, B, S, D, H, W, C, st);
  if (dtype == 1)
    return launch_backward<BF16>(gp, ref, tgt, dp, mp, kp, dref, acc, B, S, D, H, W, C, st);
  return (int)cudaErrorInvalidValue;
}
