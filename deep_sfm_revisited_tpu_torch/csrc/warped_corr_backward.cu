// The backward kernels of PWC-DC's correlations, written for Hopper
// (sm_90a): B2's (level 6, no flow) and the warped correlation's (levels
// 5..2), one template with and without the flow warp.
//
// They replace the gradients XLA derives for the JAX network's correlation
// (deep_sfm_revisited_tpu/ops/correlation.py:28, local_correlation) and,
// at levels 5..2, for its flow warp before it (models/pwcnet.py:125-131:
// warp_flow, i.e. ops/camera.py::bilinear_sample at q + s flow(q), then the
// correlation of the float32 casts). Neither TPU kernel
// (ops/pallas/local_corr.py::local_correlation_pallas,
// ops/pallas/sweep_warp.py::bilinear_sample_pallas) has a backward of its
// own in the JAX package: XLA differentiates the plain compositions.
//
// For f1, f2 (B, C, H, W), the warped map w[q] = sample(f2, q + s flow(q))
// (B1's rule, bilinear.cuh, rounded to the features' dtype as the forward
// rounds it; w = f2 without a flow) and the correlation's gradient
// g = dout (B, (2md+1)^2, H, W):
//
//   d f1[p, c] = (sum_d g[p, d] w[p + d, c]) / C                  (a gather)
//   d w[q, c]  = (sum_d g[q - d, d] f1[q - d, c]) / C             (a gather)
//
// without a flow d f2 = d w. With one, d w stays in float32 registers
// (never stored, never rounded to bfloat16) and
//
//   d f2  += d w[q, c] times each tap's bilinear weight, onto q's 4 taps
//            (float32 atomics into a zeroed float32 buffer, then one cast
//            to bfloat16 where the features are);
//   d flow[q] = s (gx, gy), gx = e_x sum_c d w[q, c] ((v01 - v00)(1 - wy)
//            + (v11 - v10) wy), gy likewise, a +1 tap beyond the frame read
//            as zero and e_x = 1/2 where x lies exactly on the first or last
//            column (JAX's zero pad and the gradient of its clip at a tie,
//            camera.py:100-118), zero where the sample is off the frame.
//
// The plain versions are ops/correlation.py::local_correlation_backward_plain
// and warped_correlation_nchw_backward_plain. The sums are float32 fmaf
// chains in displacement order; d f1 and (without a flow) d f2 are gathers,
// bit-identical across launches; d flow is reduced over a pixel's channels
// in a fixed order, so it is too; only d f2's atomics add in an order that
// changes from launch to launch.
//
// What bounds it on an H100 SXM: at the four warped levels of a b = 4,
// 256x768 PWC-DC training step in bfloat16 it must read f1, f2, the flow
// and dout once and write d f1, d f2 and d flow once, ~28 MB (8 us at
// 3.35 TB/s); its ~0.9 G products and sums of bfloat16 inputs would take
// under 1 us at the tensor cores' 989 TFLOP/s, so the bytes bound it (in
// float32, at 67 TFLOP/s outside the tensor cores, the operations do:
// ~13 us). This kernel runs the sums as float32 fmaf on the CUDA cores and
// reads each halo from shared memory once a displacement, so the
// arithmetic and the shared-memory loads, not the bytes, will set its time.
//
// Design (simple first):
//   * Mapping. A block owns an 8 x 8 tile of pixels and 512 threads: a
//     thread is (tile pixel, 32-bit word of a chunk of 8 words), the 8 words
//     of a pixel on neighbouring lanes. Channels go in chunks of 8 words (8
//     float32 or 16 bfloat16 channels), which a block walks in turn. At
//     PWC-DC's coarse levels this leaves few blocks (8 to 48 tiles a b = 4
//     step); splitting the channels across blocks is later work.
//   * Shared memory. Once a block: the taps of the (8 + 2md)^2 halo (flow
//     read once, coordinates rounded as the forward's) and dout over the
//     halo in its own dtype. A chunk: f1 and w over the halo as word planes
//     (w blended from f2's taps there, rounded to the features' dtype), the
//     planes' pitch padded so the 8 words of a pixel fall on 8 bank groups.
//   * Sums. A thread walks the 81 displacements once a chunk: g[p, d] times
//     w[p + d] into d f1, g[q - d, d] times f1[q - d] into d w.
//   * d flow. Each thread adds its channels' terms (the four taps re-read
//     from f2, L1/L2-resident) over the chunks; the 8 lanes of a pixel meet
//     by a shuffle butterfly.
//   * Host. The dynamic shared-memory attribute is set once per template
//     instantiation and device. With a flow: the kernel and (bfloat16
//     features) the cast of d f2's float32 buffer.
// Making it fast (a tile of rows a warp, clusters sharing the halo, the
// tensor cores for the sums) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bilinear.cuh"   // B1's sampling rule: Taps, blend

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 8;                           // a block's tile: kTile x kTile pixels
constexpr int kWords = 8;                          // 32-bit words of a channel chunk
constexpr int kThreads = kTile * kTile * kWords;   // 512
constexpr int kCastThreads = 256;
constexpr int kMaxDevices = 64;

// How a feature type is loaded, staged and written: a 32-bit word holds
// kCPW channels of one pixel; dout is staged as Raw bits.
template <class T>
struct Feat;

template <>
struct Feat<float> {
  using Raw = uint32_t;
  static constexpr int kCPW = 1;
  __device__ __forceinline__ static Raw raw(const float* p) { return __float_as_uint(__ldg(p)); }
  __device__ __forceinline__ static float widen(Raw r) { return __uint_as_float(r); }
  __device__ __forceinline__ static float value(const float* p) { return __ldg(p); }
  // channels [c, c + kCPW) of a pixel at p (p points at channel c), zero at or past C
  __device__ __forceinline__ static uint32_t word(const float* p, int c, int C, bool) {
    return c < C ? __float_as_uint(__ldg(p)) : 0u;
  }
  __device__ __forceinline__ static void unpack(uint32_t w, float* v) { v[0] = __uint_as_float(w); }
  __device__ __forceinline__ static uint32_t pack(const float* v) { return __float_as_uint(v[0]); }
  __device__ __forceinline__ static void store(float* p, const float* v, int c, int C, bool) {
    if (c < C) p[0] = v[0];
  }
};

template <>
struct Feat<bf16> {
  using Raw = unsigned short;
  static constexpr int kCPW = 2;
  __device__ __forceinline__ static Raw raw(const bf16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ static float widen(Raw r) { return __uint_as_float((uint32_t)r << 16); }
  __device__ __forceinline__ static float value(const bf16* p) { return widen(raw(p)); }
  // vec: C is even and the tensor 4-byte aligned, so a channel pair is one word
  __device__ __forceinline__ static uint32_t word(const bf16* p, int c, int C, bool vec) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    if (vec) return c < C ? __ldg(reinterpret_cast<const unsigned int*>(q)) : 0u;
    const uint32_t lo = c < C ? __ldg(q) : 0u;
    const uint32_t hi = c + 1 < C ? __ldg(q + 1) : 0u;
    return lo | hi << 16;
  }
  __device__ __forceinline__ static void unpack(uint32_t w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static uint32_t pack(const float* v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
  }
  __device__ __forceinline__ static void store(bf16* p, const float* v, int c, int C, bool vec) {
    if (vec) {
      if (c < C) *reinterpret_cast<uint32_t*>(p) = pack(v);
      return;
    }
    if (c < C) p[0] = __float2bfloat16_rn(v[0]);
    if (c + 1 < C) p[1] = __float2bfloat16_rn(v[1]);
  }
};

template <int MD, class T, bool FLOW>
struct Geometry {
  static constexpr int S = 2 * MD + 1;
  static constexpr int S2 = S * S;
  static constexpr int HH = kTile + 2 * MD;                // halo side
  static constexpr int HP = HH * HH;                       // halo pixels
  static constexpr int Pitch = (HP + 31) / 32 * 32 + 4;    // a word plane: 8 words on 8 bank groups
  static constexpr int CPW = Feat<T>::kCPW;
  static constexpr int Chunk = kWords * CPW;               // channels a chunk
  static constexpr int TapsBytes = FLOW ? HP * 16 : 0;
  static constexpr int GBytes = (HP * S2 * (int)sizeof(typename Feat<T>::Raw) + 15) / 16 * 16;
  static constexpr int PlaneBytes = kWords * Pitch * 4;
  static constexpr int SmemBytes = TapsBytes + GBytes + 2 * PlaneBytes;
};

// The taps of pixel (gy, gx)'s sample, which lies on the frame:
// {tap (0, 0) as the pixel index yi W + xi; flags: bit 0 a +1 column tap
// inside the frame, bit 1 a +1 row tap, bit 2 valid, bit 3 on the frame,
// bits 4-7 x == 0, x == W - 1, y == 0, y == H - 1 (the pre-clip
// coordinate exactly on an edge); wx, wy as bits}. The flow's element
// (b, k, y, x) is at b fs.x + k fs.y + y fs.z + x fs.w.
__device__ __forceinline__ int4 pixel_taps(const void* flow, bool flow_bf16, int4 fs,
                                           float scale, int b, int H, int W, int gy, int gx) {
  const int64_t q = (int64_t)b * fs.x + (int64_t)gy * fs.z + (int64_t)gx * fs.w;
  float fx, fy;
  if (flow_bf16) {
    const unsigned short* f = reinterpret_cast<const unsigned short*>(flow);
    fx = __uint_as_float((uint32_t)__ldg(f + q) << 16);
    fy = __uint_as_float((uint32_t)__ldg(f + q + fs.y) << 16);
  } else {
    const float* f = reinterpret_cast<const float*>(flow);
    fx = __ldg(f + q);
    fy = __ldg(f + q + fs.y);
  }
  // the coordinate as grid + flow * scale rounds it
  const float x = __fadd_rn((float)gx, __fmul_rn(fx, scale));
  const float y = __fadd_rn((float)gy, __fmul_rn(fy, scale));
  const Taps t(x, y, H, W);
  const int flags = (t.xi1 - t.xi) | ((t.yi1 - t.yi) << 1) | (t.valid != 0.f ? 4 : 0) | 8 |
                    (x == 0.f ? 16 : 0) | (x == (float)(W - 1) ? 32 : 0) |
                    (y == 0.f ? 64 : 0) | (y == (float)(H - 1) ? 128 : 0);
  return make_int4(t.yi * W + t.xi, flags, __float_as_int(t.wx), __float_as_int(t.wy));
}

// Halo pixel i's taps (row-major over HH x HH from (y0 - MD, x0 - MD));
// all zero where the pixel is off the frame.
template <int HH, int MD>
__device__ __forceinline__ int4 halo_taps(int i, const void* flow, bool flow_bf16, int4 fs,
                                          float scale, int b, int H, int W, int y0, int x0) {
  const int gy = y0 - MD + i / HH, gx = x0 - MD + i % HH;
  if (gy < 0 || gy >= H || gx < 0 || gx >= W) return make_int4(0, 0, 0, 0);
  return pixel_taps(flow, flow_bf16, fs, scale, b, H, W, gy, gx);
}

// d flow of one pixel from its channel sums: zero off the frame, else
// halved on an edge (per axis) and scaled, in the flow's dtype
__device__ __forceinline__ void store_dflow(void* dflow, bool flow_bf16, int4 ds, int b, int y,
                                            int x, int flags, float gx, float gy, float scale) {
  float ox = 0.f, oy = 0.f;
  if (flags & 4) {
    const float ex = ((flags & 16) ? 0.5f : 1.f) * ((flags & 32) ? 0.5f : 1.f);
    const float ey = ((flags & 64) ? 0.5f : 1.f) * ((flags & 128) ? 0.5f : 1.f);
    ox = __fmul_rn(__fmul_rn(gx, ex), scale);
    oy = __fmul_rn(__fmul_rn(gy, ey), scale);
  }
  const int64_t o = (int64_t)b * ds.x + (int64_t)y * ds.z + (int64_t)x * ds.w;
  if (flow_bf16) {
    bf16* d = reinterpret_cast<bf16*>(dflow);
    d[o] = __float2bfloat16_rn(ox);
    d[o + ds.y] = __float2bfloat16_rn(oy);
  } else {
    float* d = reinterpret_cast<float*>(dflow);
    d[o] = ox;
    d[o + ds.y] = oy;
  }
}

template <int MD, class T, bool FLOW>
__global__ void __launch_bounds__(kThreads, 2)
corr_backward_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                     const void* __restrict__ flow, int flow_bf16, int4 fs, float scale,
                     const T* __restrict__ dout, int64_t dout_sb, int64_t dout_ld,
                     T* __restrict__ df1, T* __restrict__ df2, float* __restrict__ acc,
                     void* __restrict__ dflow, int4 ds, int H, int W, int C, int vec_in) {
  using G = Geometry<MD, T, FLOW>;
  using F = Feat<T>;
  using Raw = typename F::Raw;
  constexpr int HH = G::HH, HP = G::HP, S = G::S, S2 = G::S2, CPW = G::CPW;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* taps = reinterpret_cast<int4*>(smem);
  Raw* gs = reinterpret_cast<Raw*>(smem + G::TapsBytes);
  uint32_t* f1h = reinterpret_cast<uint32_t*>(smem + G::TapsBytes + G::GBytes);
  uint32_t* wh = f1h + kWords * G::Pitch;

  const int tid = threadIdx.x;
  const int j = tid % kWords, slot = tid / kWords;
  const int r = slot / kTile, col = slot % kTile;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const int y = y0 + r, x = x0 + col;
  const bool inside = y < H && x < W;
  const int64_t image = (int64_t)b * H * W * C;   // an image's H W C < 2^31 (the launcher checks)
  const T* f1b = f1 + image;
  const T* f2b = f2 + image;
  const bool vec = vec_in != 0;

  if constexpr (FLOW) {
    for (int i = tid; i < HP; i += kThreads)
      taps[i] = halo_taps<HH, MD>(i, flow, flow_bf16 != 0, fs, scale, b, H, W, y0, x0);
  }
  const T* doutb = dout + (int64_t)b * dout_sb;
  for (int i = tid; i < HP * S2; i += kThreads) {
    const int hp = i / S2, d = i % S2;
    const int gy = y0 - MD + hp / HH, gx = x0 - MD + hp % HH;
    gs[i] = gy >= 0 && gy < H && gx >= 0 && gx < W
                ? F::raw(doutb + ((int64_t)gy * W + gx) * dout_ld + d)
                : (Raw)0;
  }

  const int own = (r + MD) * HH + col + MD;   // this thread's pixel in the halo
  float gx_acc = 0.f, gy_acc = 0.f;            // d flow's channel sums (FLOW)
  for (int cb = 0; cb < C; cb += G::Chunk) {
    __syncthreads();   // the taps and dout are staged; the previous chunk's reads are done
    for (int i = tid; i < HP * kWords; i += kThreads) {
      const int hp = i / kWords, jj = i % kWords;
      const int gy = y0 - MD + hp / HH, gx = x0 - MD + hp % HH;
      const int c = cb + jj * CPW;
      uint32_t fw = 0u, ww = 0u;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C) {
        const int p = gy * W + gx;
        fw = F::word(f1b + (int64_t)p * C + c, c, C, vec);
        if constexpr (FLOW) {
          const int4 t = taps[hp];
          const T* q = f2b + (int64_t)t.x * C + c;
          const int dx1 = (t.y & 1) * C, dy1 = ((t.y >> 1) & 1) * W * C;
          float v00[CPW], v01[CPW], v10[CPW], v11[CPW], out[CPW];
          F::unpack(F::word(q, c, C, vec), v00);
          F::unpack(F::word(q + dx1, c, C, vec), v01);
          F::unpack(F::word(q + dy1, c, C, vec), v10);
          F::unpack(F::word(q + dy1 + dx1, c, C, vec), v11);
          const float wx = __int_as_float(t.z), wy = __int_as_float(t.w);
          const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
          const float valid = (t.y & 4) ? 1.f : 0.f;
#pragma unroll
          for (int e = 0; e < CPW; ++e)
            out[e] = blend(v00[e], v01[e], v10[e], v11[e], wx, ax, wy, ay, valid);
          ww = F::pack(out);   // w in the features' dtype, as the forward rounds it
        } else {
          ww = F::word(f2b + (int64_t)p * C + c, c, C, vec);
        }
      }
      f1h[jj * G::Pitch + hp] = fw;
      wh[jj * G::Pitch + hp] = ww;
    }
    __syncthreads();

    float a1[CPW], aw[CPW];
#pragma unroll
    for (int e = 0; e < CPW; ++e) a1[e] = aw[e] = 0.f;
    const uint32_t* wrow = wh + j * G::Pitch;
    const uint32_t* frow = f1h + j * G::Pitch;
#pragma unroll 1
    for (int dy = 0; dy < S; ++dy) {
#pragma unroll
      for (int dx = 0; dx < S; ++dx) {
        const int d = dy * S + dx;
        const float gp = F::widen(gs[own * S2 + d]);          // g[p, d]
        const int qp = (r + 2 * MD - dy) * HH + col + 2 * MD - dx;   // p = q - d
        const float gq = F::widen(gs[qp * S2 + d]);           // g[q - d, d]
        float wv[CPW], fv[CPW];
        F::unpack(wrow[(r + dy) * HH + col + dx], wv);        // w[p + d]
        F::unpack(frow[qp], fv);                              // f1[q - d]
#pragma unroll
        for (int e = 0; e < CPW; ++e) {
          a1[e] = fmaf(gp, wv[e], a1[e]);
          aw[e] = fmaf(gq, fv[e], aw[e]);
        }
      }
    }

    const int c = cb + j * CPW;
    if (inside && c < C) {
      const float cf = (float)C;
      const int64_t at = image + ((int64_t)y * W + x) * C + c;
      float d1[CPW], dw[CPW];
#pragma unroll
      for (int e = 0; e < CPW; ++e) {
        d1[e] = a1[e] / cf;
        dw[e] = aw[e] / cf;
      }
      F::store(df1 + at, d1, c, C, vec);
      if constexpr (!FLOW) {
        F::store(df2 + at, dw, c, C, vec);
      } else {
        const int4 t = taps[own];
        if (t.y & 4) {   // a valid sample: scatter d w and add d flow's terms
          const float wx = __int_as_float(t.z), wy = __int_as_float(t.w);
          const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
          const bool hx = t.y & 1, hy = (t.y >> 1) & 1;
          const int64_t i00 = image + (int64_t)t.x * C + c;
          const int64_t i01 = i00 + (hx ? C : 0), i10 = i00 + (hy ? (int64_t)W * C : 0);
          const int64_t i11 = i10 + (hx ? C : 0);
#pragma unroll
          for (int e = 0; e < CPW; ++e) {
            if (c + e >= C) break;
            const float top = __fmul_rn(dw[e], ay), bot = __fmul_rn(dw[e], wy);
            atomicAdd(acc + i00 + e, __fmul_rn(top, ax));
            atomicAdd(acc + i01 + e, __fmul_rn(top, wx));
            atomicAdd(acc + i10 + e, __fmul_rn(bot, ax));
            atomicAdd(acc + i11 + e, __fmul_rn(bot, wx));
            const float v00 = F::value(f2 + i00 + e);
            const float z01 = hx ? F::value(f2 + i01 + e) : 0.f;
            const float z10 = hy ? F::value(f2 + i10 + e) : 0.f;
            const float z11 = hx && hy ? F::value(f2 + i11 + e) : 0.f;
            const float tx = __fadd_rn(__fmul_rn(__fsub_rn(z01, v00), ay),
                                       __fmul_rn(__fsub_rn(z11, z10), wy));
            const float ty = __fadd_rn(__fmul_rn(__fsub_rn(z10, v00), ax),
                                       __fmul_rn(__fsub_rn(z11, z01), wx));
            gx_acc = __fadd_rn(gx_acc, __fmul_rn(dw[e], tx));
            gy_acc = __fadd_rn(gy_acc, __fmul_rn(dw[e], ty));
          }
        }
      }
    }
  }

  if constexpr (FLOW) {
    // the 8 lanes of a pixel: a butterfly gives every lane the same bits
#pragma unroll
    for (int o = 1; o < kWords; o <<= 1) {
      gx_acc += __shfl_xor_sync(0xffffffffu, gx_acc, o);
      gy_acc += __shfl_xor_sync(0xffffffffu, gy_acc, o);
    }
    if (j == 0 && inside)
      store_dflow(dflow, flow_bf16 != 0, ds, b, y, x, taps[own].y, gx_acc, gy_acc, scale);
  }
}

// d f2 of bfloat16 features: the float32 buffer, cast (the same memory order)
__global__ void __launch_bounds__(kCastThreads)
cast_bf16_kernel(const float* __restrict__ in, bf16* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kCastThreads;
  for (int64_t i = (int64_t)blockIdx.x * kCastThreads + threadIdx.x; i < n; i += stride)
    out[i] = __float2bfloat16_rn(__ldcs(in + i));
}

struct Args {
  const void *f1, *f2, *flow;
  int flow_bf16;
  int4 fs;
  float scale;
  const void* dout;
  int64_t dout_sb, dout_ld;
  void *df1, *df2;
  float* acc;
  void* dflow;
  int4 ds;
  int B, H, W, C;
  cudaStream_t stream;
};

int grid_blocks(int64_t n) {
  return (int)std::min<int64_t>((n + kCastThreads - 1) / kCastThreads, 4096);
}

template <int MD, class T, bool FLOW>
cudaError_t launch(const Args& a) {
  using G = Geometry<MD, T, FLOW>;
  auto kernel = corr_backward_kernel<MD, T, FLOW>;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::SmemBytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int tiles_x = (a.W + kTile - 1) / kTile, tiles_y = (a.H + kTile - 1) / kTile;
  if (tiles_y > 65535 || a.B > 65535 || (int64_t)a.C * a.H * a.W >= (int64_t(1) << 31))
    return cudaErrorInvalidConfiguration;
  const uintptr_t al = reinterpret_cast<uintptr_t>(a.f1) | reinterpret_cast<uintptr_t>(a.f2) |
                       reinterpret_cast<uintptr_t>(a.df1) |
                       reinterpret_cast<uintptr_t>(FLOW ? a.f1 : a.df2);
  const int vec = (int64_t)a.C * (int64_t)sizeof(T) % 4 == 0 && (al & 3) == 0;
  kernel<<<dim3(tiles_x, tiles_y, a.B), kThreads, G::SmemBytes, a.stream>>>(
      reinterpret_cast<const T*>(a.f1), reinterpret_cast<const T*>(a.f2), a.flow, a.flow_bf16,
      a.fs, a.scale, reinterpret_cast<const T*>(a.dout), a.dout_sb, a.dout_ld,
      reinterpret_cast<T*>(a.df1), reinterpret_cast<T*>(a.df2), a.acc, a.dflow, a.ds, a.H, a.W,
      a.C, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (FLOW && sizeof(T) == 2) {
    const int64_t n = (int64_t)a.B * a.H * a.W * a.C;
    cast_bf16_kernel<<<grid_blocks(n), kCastThreads, 0, a.stream>>>(
        a.acc, reinterpret_cast<bf16*>(a.df2), n);
    err = cudaGetLastError();
  }
  return err;
}

template <class T, bool FLOW>
cudaError_t by_md(int md, const Args& a) {
  switch (md) {
    case 1: return launch<1, T, FLOW>(a);
    case 2: return launch<2, T, FLOW>(a);
    case 3: return launch<3, T, FLOW>(a);
    case 4: return launch<4, T, FLOW>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B2's backward: f0, f1 (B, H, W, C) float32 contiguous, dout (B, H, W,
// (2md+1)^2) float32 contiguous -> d f0, d f1 (B, H, W, C) float32. The
// flow-free case of the template, on the NHWC maps seen as channels-last
// NCHW. md in 1..4. Returns the cudaError_t of the launch (0 on success).
extern "C" int dsfm_local_correlation_backward(const void* f0, const void* f1, const void* dout,
                                               void* df0, void* df1, int B, int H, int W, int C,
                                               int md, void* stream) {
  const int s2 = (2 * md + 1) * (2 * md + 1);
  Args a = {f0, f1, nullptr, 0, make_int4(0, 0, 0, 0), 0.f, dout, (int64_t)H * W * s2, s2,
            df0, df1, nullptr, nullptr, make_int4(0, 0, 0, 0), B, H, W, C,
            reinterpret_cast<cudaStream_t>(stream)};
  return (int)by_md<float, false>(md, a);
}

// The warped correlation's backward: f1, f2 (B, C, H, W) channels-last of
// `dtype` (0 = float32, 1 = bfloat16); flow (B, 2, H, W) of `flow_dtype`,
// its element (b, k, y, x) at b fs_b + k fs_k + y fs_y + x fs_x; dout
// (B, (2md+1)^2, H, W) of `dtype`, element (b, d, y, x) at b dout_sb +
// (y W + x) dout_ld + d. Writes d f1 and d f2 (channels-last, `dtype`) and
// d flow (`flow_dtype`, strides ds_*). acc: a zeroed float32 (B, H, W, C)
// buffer, which is d f2 itself for float32 features. md in 1..4. Returns
// the cudaError_t of the launches (0 on success).
extern "C" int dsfm_warped_correlation_backward(
    const void* f1, const void* f2, const void* flow, int flow_dtype, int fs_b, int fs_k,
    int fs_y, int fs_x, float scale, const void* dout, long long dout_sb, long long dout_ld,
    void* df1, void* df2, float* acc, void* dflow, int ds_b, int ds_k, int ds_y, int ds_x, int B,
    int H, int W, int C, int md, int dtype, void* stream) {
  if (flow_dtype != 0 && flow_dtype != 1) return (int)cudaErrorInvalidValue;
  Args a = {f1, f2, flow, flow_dtype, make_int4(fs_b, fs_k, fs_y, fs_x), scale, dout,
            (int64_t)dout_sb, (int64_t)dout_ld, df1, df2, acc, dflow,
            make_int4(ds_b, ds_k, ds_y, ds_x), B, H, W, C, reinterpret_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)by_md<float, true>(md, a);
  if (dtype == 1) return (int)by_md<bf16, true>(md, a);
  return (int)cudaErrorInvalidValue;
}
