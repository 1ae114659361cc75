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
// in a fixed order (a thread's 8 channels in turn, then the block's
// threads, then the cluster's ranks), so it is too; only d f2's atomics
// add in an order that changes from launch to launch.
//
// What bounds it on an H100 SXM: at the four warped levels of a b = 4,
// 256x768 PWC-DC training step in bfloat16 it must read f1, f2, the flow
// and the dout elements whose p + d lies in the frame once and write d f1,
// d f2 and d flow once, 32.4 MB (9.7 us at 3.35 TB/s; level 2 alone 20.6
// MB); its ~0.9 G products and sums of bfloat16 inputs would take under
// 1 us at the tensor cores' 989 TFLOP/s, so the bytes bound it. Level 6
// (B2's, float32) moves 0.62 MB: a launch's latency sets its floor. The
// sums run as float32 fmaf on the CUDA cores (255 M at level 2: ~8 us at
// the card's 67 TFLOP/s), fed from shared memory. At these sizes (768 to
// 49152 pixels a level) what sets the time is the chain of dependent
// steps a block runs (stage, sum, stage, sum, scatter) and how many
// threads the card has to hide it with, not the bytes.
//
// Design (replacing a first version in which one 8x8 block walked every
// channel chunk over a 16x16 dout halo with four shared loads a product):
//   * Mapping. The grid is (tile x channel group, tile row, image). A
//     block owns a TH x TW tile and a group of NS slots of 8 channels; a
//     thread owns a run of RUN = 1, 2 or 4 pixels along a row and one slot
//     (tid = slot + NS (run + TW/RUN row)). ops/cuda/local_corr.py::
//     backward_plan picks TH, TW, RUN and NS per level from a measured
//     grid: runs of 1 at the coarse levels (more threads), 4 at level 2
//     (more reuse a shared load).
//   * Channel groups. Without a flow, d f1 and d f2 are per-channel
//     gathers: the groups are independent blocks. With a flow, the G groups
//     of a tile form a thread-block cluster (G <= 8); each rank keeps its
//     channels' partial d-flow sums, and after cluster.sync() the ranks add
//     them through distributed shared memory in rank order: one launch, no
//     buffer, no second kernel.
//   * dout staged once, two ways, each only where the sums read it: g[q -
//     d, d] on the tile's pixels for d w, then g[p, d] for d f1 (2 x tile x
//     (2md+1)^2 values over the block's life, in one buffer). Index tables
//     built once a block (each halo pixel's frame index, each tile pixel's
//     halo index) leave the staging loops no division but by constants;
//     the scattered g[q - d, d] loads are issued 32 at a time a thread, the
//     contiguous g[p, d] runs are copied by 4-byte cp.async, exactly the
//     run (a bfloat16 run that starts on an odd value, as PWC-DC's channel
//     slice of an odd pixel stride gives every other pixel, is staged one
//     value in).
//   * Two passes, one halo buffer. Pass 1 stages f1's halo (16-byte units
//     of a pixel's channels by cp.async, at a unit pitch that keeps a
//     quarter-warp's loads on distinct banks) and sums d w; pass 2 stages
//     the warped halo in the same buffer and sums d f1. So a block holds one
//     halo and one dout plane, and more blocks fit an SM.
//   * Register-tiled sums. A thread slides its RUN pixels over the row of
//     halo units of each displacement row: each 16-byte unit (8 bfloat16 or
//     4 float32 channels) loaded from shared memory serves up to RUN
//     pixels, each g value 8 channels (the first version: 4 shared loads for 2
//     products in bfloat16).
//   * d flow from staged taps, d f2 by vector reductions. Pass 2's own
//     pixels are blended by the thread that owns them: with its d w in
//     registers it adds d flow's terms from the four taps it just loaded
//     (f2 is not read again) and scatters d f2 as float4 atomicAdds
//     (red.global.add.v4.f32) where C % 4 == 0, scalar ones elsewhere.
//   * Host. The dynamic shared-memory attribute is set once per template
//     instantiation and device; a call is the kernel (a cluster launch
//     where G > 1) and, with bfloat16 features and a flow, the cast of d
//     f2's float32 buffer; the caller zeroes the buffer.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bilinear.cuh"   // B1's sampling rule: Taps, blend

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSlot = 8;           // channels a thread owns
constexpr int kMaxThreads = 512;   // threads a block (the plan keeps under it)
constexpr int kMaxCluster = 8;     // ranks of a cluster: the portable size
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may take (227 KB)
constexpr int kBatch = 32;         // staged dout values a thread has in flight
constexpr int kCastThreads = 256;
constexpr int kMaxDevices = 64;

// Items i = tid, tid + threads, ... < n: load(i) for B of them, then put(i,
// value) for those, so that each thread keeps B loads in flight.
template <int B, class Load, class Put>
__device__ __forceinline__ void staged(int n, int tid, int threads, Load load, Put put) {
  for (int base = tid; base < n; base += B * threads) {
    decltype(load(0)) v[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = base + u * threads;
      if (i < n) v[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = base + u * threads;
      if (i < n) put(i, v[u]);
    }
  }
}

// 16 bytes from global to shared memory, asynchronously; zeros where !full
// (no byte is read then)
__device__ __forceinline__ void copy16(void* dst, const void* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}

// 4 bytes likewise (through L1)
__device__ __forceinline__ void copy4(void* dst, const void* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// How a feature type is loaded, staged and written. A 16-byte unit holds
// kE channels of one pixel; a slot (8 channels) is kQS units; dout is
// staged as Raw values.
template <class T>
struct Feat;

template <>
struct Feat<float> {
  using Raw = float;
  static constexpr int kE = 4;
  static constexpr int kQS = 2;
  __device__ __forceinline__ static Raw raw(const float* p) { return __ldg(p); }
  __device__ __forceinline__ static float widen(Raw r) { return r; }
  // channels [c, c + 4) at p (p at channel c), n = C - c of them present;
  // vec: one 16-byte load (the launcher checked C and the alignment)
  __device__ __forceinline__ static uint4 unit(const float* p, int n, bool vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = k < n ? __float_as_uint(__ldg(p + k)) : 0u;
    return make_uint4(e[0], e[1], e[2], e[3]);
  }
  __device__ __forceinline__ static void unpack(uint4 u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ __forceinline__ static void store(float* p, const float* v, int n, bool vec) {
    if (vec) {
      *reinterpret_cast<uint4*>(p) = pack(v);
      return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < n) p[k] = v[k];
  }
};

template <>
struct Feat<bf16> {
  using Raw = unsigned short;
  static constexpr int kE = 8;
  static constexpr int kQS = 1;
  __device__ __forceinline__ static Raw raw(const bf16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ static float widen(Raw r) { return __uint_as_float((uint32_t)r << 16); }
  __device__ __forceinline__ static uint4 unit(const bf16* p, int n, bool vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    uint32_t e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = k < n ? (uint32_t)__ldg(q + k) : 0u;
    return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                      e[6] | e[7] << 16);
  }
  __device__ __forceinline__ static void unpack(uint4 u, float* v) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t pack2(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
  __device__ __forceinline__ static void store(bf16* p, const float* v, int n, bool vec) {
    if (vec) {
      *reinterpret_cast<uint4*>(p) = pack(v);
      return;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < n) p[k] = __float2bfloat16_rn(v[k]);
  }
};

// The displacement window and the staged dout's pixel pitch (an even
// number of bfloat16 values, so a pixel's run starts on a word).
template <int MD, class T>
struct Window {
  static constexpr int S = 2 * MD + 1;
  static constexpr int S2 = S * S;
  static constexpr int GP = S2 + (sizeof(T) == 2 && S2 % 2 == 1 ? 1 : 0);
};

// A block's shared memory: the halo of (TH + 2md) x (TW + 2md) pixels, its
// 16-byte units at an odd pitch; the staged dout (TH TW pixels at GP); two
// index tables (each halo pixel's index in the frame, or -1 off it; each
// tile pixel's index in the halo, or -1 off the frame); with a flow the
// halo's taps, each thread's partial d flow of its pixels and the block's
// partial d flow of each pixel (read by rank 0's cluster sum).
// ops/cuda/local_corr.py::backward_smem computes the same offsets.
struct Layout {
  int hh, hw, qp, g, tabs, taps, part, blk, total;
};

template <int MD, class T, bool FLOW>
__host__ __device__ __forceinline__ Layout layout(int TH, int TW, int NS) {
  Layout l;
  l.hh = TH + 2 * MD;
  l.hw = TW + 2 * MD;
  l.qp = (NS * Feat<T>::kQS) | 1;
  const int hp = l.hh * l.hw;
  l.g = hp * l.qp * 16;
  const int gbytes = TH * TW * Window<MD, T>::GP * (int)sizeof(typename Feat<T>::Raw);
  l.tabs = l.g + (gbytes + 15) / 16 * 16;
  l.taps = l.tabs + ((hp + TH * TW) * 4 + 15) / 16 * 16;
  l.part = l.taps + (FLOW ? hp * 16 : 0);
  l.blk = l.part + (FLOW ? TH * TW * NS * 8 : 0);
  l.total = l.blk + (FLOW ? TH * TW * 8 : 0);
  return l;
}

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

// The register-tiled sums of one pass over the staged halo and dout. A
// thread's pixels i = 0..RUN-1 lie at tile column cr + i of tile row `row`
// and their staged dout at g + goff[i]; its slot's units at s kQS. D_F1:
// d f1[p] += g[p, d] w[p + d], halo row row + dy, column cr + j with j =
// i + dx (j ascending); else d w[q] += g[q - d, d] f1[q - d], halo row row
// + 2md - dy, j = i + 2md - dx (j descending). Either way each pixel's
// chain runs in displacement order.
template <int MD, class T, int RUN, bool D_F1>
__device__ __forceinline__ void window_sums(float (&acc)[RUN][kSlot], const uint4* __restrict__ halo,
                                            int qp, int hw, const typename Feat<T>::Raw* __restrict__ g,
                                            const int (&goff)[RUN], int row, int cr, int s) {
  using F = Feat<T>;
  constexpr int S = Window<MD, T>::S, QS = F::kQS, E = F::kE;
  constexpr int J = RUN + 2 * MD;
#pragma unroll 1
  for (int dy = 0; dy < S; ++dy) {
    const int hr = D_F1 ? row + dy : row + 2 * MD - dy;
    const uint4* hrow = halo + (hr * hw + cr) * qp + s * QS;
    const typename F::Raw* gd = g + dy * S;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int j = D_F1 ? jj : J - 1 - jj;
      float v[kSlot];
#pragma unroll
      for (int t = 0; t < QS; ++t) F::unpack(hrow[j * qp + t], v + t * E);
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        const int dx = D_F1 ? j - i : i + 2 * MD - j;
        if (dx >= 0 && dx <= 2 * MD) {
          const float gv = F::widen(gd[goff[i] + dx]);
#pragma unroll
          for (int k = 0; k < kSlot; ++k) acc[i][k] = fmaf(gv, v[k], acc[i][k]);
        }
      }
    }
  }
}

// A thread's 4 pixels x 8 channels, divided by C, written at `out` (B, H,
// W, C) where the pixel and channel exist
template <class T, int RUN>
__device__ __forceinline__ void store_run(T* __restrict__ out, const float (&a)[RUN][kSlot],
                                          int64_t image, int y, int x0, int H, int W, int C, int c0,
                                          bool vec) {
  using F = Feat<T>;
  if (y >= H) return;
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const int x = x0 + i;
    if (x >= W) break;
#pragma unroll
    for (int t = 0; t < F::kQS; ++t) {
      const int c = c0 + t * F::kE;
      if (c < C) F::store(out + image + ((int64_t)y * W + x) * C + c, a[i] + t * F::kE, C - c, vec);
    }
  }
}

// The halo of features `img` (one image), raw: unit u of halo pixel hp =
// channels [cb + u E, + E) of frame pixel frame[hp], zero off the frame
// (frame[hp] < 0) or past C. 16-byte units by cp.async where `vec` (else
// value by value); the caller waits (copies_done) and synchronises.
template <class T>
__device__ __forceinline__ void stage_halo(uint4* __restrict__ halo, const T* __restrict__ img,
                                           const int* __restrict__ frame, int nhalo, int Q,
                                           int qp, int C, int cb, bool vec, int tid,
                                           int threads) {
  using F = Feat<T>;
  constexpr int E = F::kE;
  const int qlog = __ffs(Q) - 1;   // Q is a power of two (the launcher checks)
  for (int i = tid; i < nhalo * Q; i += threads) {
    const int hp = i >> qlog, u = i & (Q - 1), c = cb + u * E, o = frame[hp];
    const bool on = o >= 0 && c < C;
    if (vec) {
      copy16(halo + hp * qp + u, on ? img + (int64_t)o * C + c : img, on);
    } else {
      halo[hp * qp + u] =
          on ? F::unit(img + (int64_t)o * C + c, C - c, false) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int MD, class T, bool FLOW, int RUN>
__global__ void __launch_bounds__(kMaxThreads)
corr_backward_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                     const void* __restrict__ flow, int flow_bf16, int4 fs, float scale,
                     const T* __restrict__ dout, int64_t dout_sb, int64_t dout_ld,
                     T* __restrict__ df1, T* __restrict__ df2, float* __restrict__ acc,
                     void* __restrict__ dflow, int4 ds, int H, int W, int C, int TH, int TW,
                     int NS, int G, int vec_in, int red_in) {
  using F = Feat<T>;
  using Raw = typename F::Raw;
  constexpr int S = Window<MD, T>::S, S2 = Window<MD, T>::S2, GP = Window<MD, T>::GP;
  constexpr int QS = F::kQS, E = F::kE;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<MD, T, FLOW>(TH, TW, NS);
  uint4* halo = reinterpret_cast<uint4*>(smem);
  Raw* gs = reinterpret_cast<Raw*>(smem + L.g);
  int* frame = reinterpret_cast<int*>(smem + L.tabs);   // halo pixel -> gy W + gx, or -1
  int* inhalo = frame + L.hh * L.hw;                     // tile pixel -> halo pixel, or -1
  int4* taps = reinterpret_cast<int4*>(smem + L.taps);
  float2* part = reinterpret_cast<float2*>(smem + L.part);
  float2* blk = reinterpret_cast<float2*>(smem + L.blk);

  const int threads = blockDim.x, tid = threadIdx.x;
  const int NR = TW / RUN;
  const int s = tid % NS, run = (tid / NS) % NR, row = tid / (NS * NR);
  const int group = blockIdx.x % G;
  const int x0 = (blockIdx.x / G) * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const int cb = group * NS * kSlot;   // the group's first channel
  const int c0 = cb + s * kSlot;       // this thread's slot
  const int cr = run * RUN;            // its pixels' first column in the tile
  const int y = y0 + row;
  const int npix = TH * TW, nhalo = L.hh * L.hw, Q = NS * QS;
  const int64_t image = (int64_t)b * H * W * C;   // an image's H W C < 2^31 (the launcher checks)
  const T* f1b = f1 + image;
  const T* f2b = f2 + image;
  const T* doutb = dout + (int64_t)b * dout_sb;
  const bool vec = vec_in != 0;

  // the index tables: the staging loops below divide by nothing but constants
  for (int i = tid; i < nhalo; i += threads) {
    const int gy = y0 - MD + i / L.hw, gx = x0 - MD + i % L.hw;
    frame[i] = gy >= 0 && gy < H && gx >= 0 && gx < W ? gy * W + gx : -1;
  }
  for (int q = tid; q < npix; q += threads) {
    const int r = q / TW, c = q % TW;
    inhalo[q] = y0 + r < H && x0 + c < W ? (r + MD) * L.hw + c + MD : -1;
  }
  __syncthreads();

  // in bfloat16, 1 where tile pixel q's run of dout starts on an odd value
  auto gp_parity = [&](int q) {
    if constexpr (sizeof(Raw) == 4) return 0;
    const int h = inhalo[q];
    return h < 0 ? 0
                 : (int)((reinterpret_cast<uintptr_t>(doutb + (int64_t)frame[h] * dout_ld) >> 1) &
                         1);
  };

  // --- pass 1: the taps, dout as g[q - d, d] on the tile, f1's halo; d w ---
  if constexpr (FLOW) {
    for (int i = tid; i < nhalo; i += threads) {
      const int gy = y0 - MD + i / L.hw, gx = x0 - MD + i % L.hw;
      taps[i] = frame[i] < 0 ? make_int4(0, 0, 0, 0)
                             : pixel_taps(flow, flow_bf16 != 0, fs, scale, b, H, W, gy, gx);
    }
  }
  // g[q - d, d]: the source is halo pixel inhalo[q] + (md - dy, md - dx)
  staged<kBatch>(
      npix * S2, tid, threads,
      [&](int i) {
        const int q = i / S2, d = i - q * S2;
        const int h = inhalo[q];
        Raw v = Raw(0);
        if (h >= 0) {
          const int o = frame[h + (MD - d / S) * L.hw + MD - d % S];
          if (o >= 0) v = F::raw(doutb + (int64_t)o * dout_ld + d);
        }
        return v;
      },
      [&](int i, Raw v) { gs[(i / S2) * GP + i % S2] = v; });
  stage_halo(halo, f1b, frame, nhalo, Q, L.qp, C, cb, vec, tid, threads);
  copies_done();
  __syncthreads();

  float a[RUN][kSlot];
#pragma unroll
  for (int i = 0; i < RUN; ++i)
#pragma unroll
    for (int k = 0; k < kSlot; ++k) a[i][k] = 0.f;
  int goff[RUN];   // the thread's pixels' staged dout
#pragma unroll
  for (int i = 0; i < RUN; ++i) goff[i] = (row * TW + cr + i) * GP;
  window_sums<MD, T, RUN, false>(a, halo, L.qp, L.hw, gs, goff, row, cr, s);
  const float cf = (float)C;
#pragma unroll
  for (int i = 0; i < RUN; ++i)
#pragma unroll
    for (int k = 0; k < kSlot; ++k) a[i][k] = a[i][k] / cf;   // d w
  if constexpr (!FLOW) store_run(df2, a, image, y, x0 + cr, H, W, C, c0, vec);
  __syncthreads();   // pass 1's reads of the halo and dout are done

  // --- pass 2: dout as g[p, d], the warped halo (d f2, d flow); d f1 ---
  // g[p, d]: a pixel's run of S2 values by 4-byte copies of exactly the
  // run. In bfloat16 a run that starts on an odd value (gp_parity) is
  // staged one value in: its first value alone, then (S2 - 1) / 2 words;
  // one that starts on an even value: the words, then its last value.
  {
    constexpr int NW = sizeof(Raw) == 4 ? S2 : (S2 - 1) / 2;   // words a run
    constexpr int NI = sizeof(Raw) == 4 ? S2 : NW + 1;         // items a run
    for (int i = tid; i < npix * NI; i += threads) {
      const int q = i / NI, k = i - q * NI;
      const int h = inhalo[q], par = gp_parity(q);
      const T* run = h >= 0 ? doutb + (int64_t)frame[h] * dout_ld : doutb;
      if (k < NW) {   // values par + 2k, par + 2k + 1 (bf16) at the row's word k + par
        copy4(reinterpret_cast<uint32_t*>(gs + q * GP) + k + par,
              run + par + k * (4 / (int)sizeof(Raw)), h >= 0);
      } else {        // bf16: the one value outside the words
        const int e = par ? 0 : S2 - 1;
        gs[q * GP + e + par] = h >= 0 ? F::raw(run + e) : Raw(0);
      }
    }   // the copies are waited for below, after the halo's staging
  }
  if constexpr (FLOW) {
    // the halo's border, by every thread; the tile's own pixels are their
    // owners' (below). (Holding 2 or 4 units' taps in flight measured no
    // faster than 1.)
    const int qlog = __ffs(Q) - 1;
    for (int i = tid; i < nhalo * Q; i += threads) {
      const int hp = i >> qlog, u = i & (Q - 1), c = cb + u * E;
      const int hy = hp / L.hw, hx = hp % L.hw;
      if (hy >= MD && hy < MD + TH && hx >= MD && hx < MD + TW) continue;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (frame[hp] >= 0 && c < C) {
        const int4 t = taps[hp];
        const T* q = f2b + (int64_t)t.x * C + c;
        const int dx1 = (t.y & 1) * C, dy1 = ((t.y >> 1) & 1) * W * C;
        float v00[E], v01[E], v10[E], v11[E], w[E];
        F::unpack(F::unit(q, C - c, vec), v00);
        F::unpack(F::unit(q + dx1, C - c, vec), v01);
        F::unpack(F::unit(q + dy1, C - c, vec), v10);
        F::unpack(F::unit(q + dy1 + dx1, C - c, vec), v11);
        const float wx = __int_as_float(t.z), wy = __int_as_float(t.w);
        const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
        const float valid = (t.y & 4) ? 1.f : 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e)
          w[e] = blend(v00[e], v01[e], v10[e], v11[e], wx, ax, wy, ay, valid);
        out = F::pack(w);   // w in the features' dtype, as the forward rounds it
      }
      halo[hp * L.qp + u] = out;
    }
    // this thread's pixels and slot: w, then with its d w d f2's scatter
    // and d flow's terms; the taps' loads of kOwn pixels in flight together
    constexpr int kOwn = QS == 1 && RUN > 1 ? 2 : 1;
    const bool red4 = red_in != 0;
#pragma unroll
    for (int i0 = 0; i0 < RUN; i0 += kOwn) {
      uint4 tv[kOwn][QS][4];
#pragma unroll
      for (int ii = 0; ii < kOwn; ++ii) {
        const int i = i0 + ii, x = x0 + cr + i;
        const int4 t = taps[(row + MD) * L.hw + cr + i + MD];
        const bool hx = t.y & 1, hy = (t.y >> 1) & 1;
#pragma unroll
        for (int tq = 0; tq < QS; ++tq) {
          const int c = c0 + tq * E;
#pragma unroll
          for (int k = 0; k < 4; ++k) tv[ii][tq][k] = make_uint4(0u, 0u, 0u, 0u);
          if (y < H && x < W && c < C) {
            const T* q = f2 + image + (int64_t)t.x * C + c;
            const int dx1 = hx ? C : 0, dy1 = hy ? W * C : 0;
            tv[ii][tq][0] = F::unit(q, C - c, vec);
            tv[ii][tq][1] = F::unit(q + dx1, C - c, vec);
            tv[ii][tq][2] = F::unit(q + dy1, C - c, vec);
            tv[ii][tq][3] = F::unit(q + dy1 + dx1, C - c, vec);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < kOwn; ++ii) {
        const int i = i0 + ii, x = x0 + cr + i;
        const int hp = (row + MD) * L.hw + cr + i + MD;
        const bool on = y < H && x < W;
        const int4 t = taps[hp];
        const float wx = __int_as_float(t.z), wy = __int_as_float(t.w);
        const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
        const bool valid = (t.y & 4) != 0, hx = t.y & 1, hy = (t.y >> 1) & 1;
        float gx = 0.f, gy = 0.f;
#pragma unroll
        for (int tq = 0; tq < QS; ++tq) {
          const int c = c0 + tq * E;
          uint4 out = make_uint4(0u, 0u, 0u, 0u);
          if (on && c < C) {
            const int64_t i00 = image + (int64_t)t.x * C + c;
            const int64_t i01 = i00 + (hx ? C : 0), i10 = i00 + (hy ? (int64_t)W * C : 0);
            const int64_t i11 = i10 + (hx ? C : 0);
            float v00[E], v01[E], v10[E], v11[E], w[E];
            F::unpack(tv[ii][tq][0], v00);
            F::unpack(tv[ii][tq][1], v01);
            F::unpack(tv[ii][tq][2], v10);
            F::unpack(tv[ii][tq][3], v11);
#pragma unroll
            for (int e = 0; e < E; ++e)
              w[e] = blend(v00[e], v01[e], v10[e], v11[e], wx, ax, wy, ay, valid ? 1.f : 0.f);
            out = F::pack(w);
            if (valid) {
              const float* dw = a[i] + tq * E;
              float p00[E], p01[E], p10[E], p11[E];
#pragma unroll
              for (int e = 0; e < E; ++e) {
                const float top = __fmul_rn(dw[e], ay), bot = __fmul_rn(dw[e], wy);
                p00[e] = __fmul_rn(top, ax);
                p01[e] = __fmul_rn(top, wx);
                p10[e] = __fmul_rn(bot, ax);
                p11[e] = __fmul_rn(bot, wx);
                if (c + e < C) {
                  const float z01 = hx ? v01[e] : 0.f, z10 = hy ? v10[e] : 0.f;
                  const float z11 = hx && hy ? v11[e] : 0.f;
                  const float tx = __fadd_rn(__fmul_rn(__fsub_rn(z01, v00[e]), ay),
                                             __fmul_rn(__fsub_rn(z11, z10), wy));
                  const float ty = __fadd_rn(__fmul_rn(__fsub_rn(z10, v00[e]), ax),
                                             __fmul_rn(__fsub_rn(z11, z01), wx));
                  gx = __fadd_rn(gx, __fmul_rn(dw[e], tx));
                  gy = __fadd_rn(gy, __fmul_rn(dw[e], ty));
                }
              }
              if (red4) {
#pragma unroll
                for (int m = 0; m < E; m += 4) {
                  if (c + m >= C) break;   // C % 4 == 0: a run of 4 is whole or absent
                  atomicAdd(reinterpret_cast<float4*>(acc + i00 + m),
                            make_float4(p00[m], p00[m + 1], p00[m + 2], p00[m + 3]));
                  atomicAdd(reinterpret_cast<float4*>(acc + i01 + m),
                            make_float4(p01[m], p01[m + 1], p01[m + 2], p01[m + 3]));
                  atomicAdd(reinterpret_cast<float4*>(acc + i10 + m),
                            make_float4(p10[m], p10[m + 1], p10[m + 2], p10[m + 3]));
                  atomicAdd(reinterpret_cast<float4*>(acc + i11 + m),
                            make_float4(p11[m], p11[m + 1], p11[m + 2], p11[m + 3]));
                }
              } else {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                  if (c + e >= C) break;
                  atomicAdd(acc + i00 + e, p00[e]);
                  atomicAdd(acc + i01 + e, p01[e]);
                  atomicAdd(acc + i10 + e, p10[e]);
                  atomicAdd(acc + i11 + e, p11[e]);
                }
              }
            }
          }
          halo[hp * L.qp + s * QS + tq] = out;
        }
        part[((row * TW) + cr + i) * NS + s] = make_float2(gx, gy);
      }
    }
  } else {
    stage_halo(halo, f2b, frame, nhalo, Q, L.qp, C, cb, vec, tid, threads);
  }
  copies_done();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RUN; ++i)
#pragma unroll
    for (int k = 0; k < kSlot; ++k) a[i][k] = 0.f;
#pragma unroll
  for (int i = 0; i < RUN; ++i) goff[i] += gp_parity(row * TW + cr + i);   // one value in
  window_sums<MD, T, RUN, true>(a, halo, L.qp, L.hw, gs, goff, row, cr, s);
#pragma unroll
  for (int i = 0; i < RUN; ++i)
#pragma unroll
    for (int k = 0; k < kSlot; ++k) a[i][k] = a[i][k] / cf;   // d f1
  store_run(df1, a, image, y, x0 + cr, H, W, C, c0, vec);

  if constexpr (FLOW) {
    // d flow: each pixel's slots in order, then the cluster's ranks in order
    for (int q = tid; q < npix; q += threads) {
      float gx = 0.f, gy = 0.f;
      for (int k = 0; k < NS; ++k) {
        const float2 p = part[q * NS + k];
        gx = __fadd_rn(gx, p.x);
        gy = __fadd_rn(gy, p.y);
      }
      blk[q] = make_float2(gx, gy);
    }
    cg::cluster_group cluster = cg::this_cluster();
    if (G > 1) cluster.sync(); else __syncthreads();
    const int rank = G > 1 ? (int)cluster.block_rank() : 0;
    for (int q = rank * threads + tid; q < npix; q += G * threads) {
      const int qy = y0 + q / TW, qx = x0 + q % TW;
      if (qy >= H || qx >= W) continue;
      float2 v = blk[q];
      if (G > 1) {
        v = make_float2(0.f, 0.f);
        for (int k = 0; k < G; ++k) {   // fixed rank order
          const float2 p = cluster.map_shared_rank(blk, k)[q];
          v.x = __fadd_rn(v.x, p.x);
          v.y = __fadd_rn(v.y, p.y);
        }
      }
      const int flags = taps[(q / TW + MD) * L.hw + q % TW + MD].y;
      store_dflow(dflow, flow_bf16 != 0, ds, b, qy, qx, flags, v.x, v.y, scale);
    }
    if (G > 1) cluster.sync();   // no block leaves while its partials are read
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
  int tile_h, tile_w, run, slots;
  cudaStream_t stream;
};

int grid_blocks(int64_t n) {
  return (int)std::min<int64_t>((n + kCastThreads - 1) / kCastThreads, 4096);
}

// The mapping's geometry, or an error where the kernel does not take it:
// a tile of tile_h rows (>= 1) and tile_w columns (a multiple of RUN),
// slots (a power of two) x 8 channels a group, at most kMaxThreads
// threads, the shared memory within kSmemMax, and with a flow at most
// kMaxCluster groups.
template <int MD, class T, bool FLOW, int RUN>
cudaError_t geometry(int C, int th, int tw, int ns, int* threads, int* groups, int* smem) {
  if (th < 1 || tw < RUN || tw % RUN != 0 || ns < 1 || (ns & (ns - 1)) != 0)
    return cudaErrorInvalidValue;
  const int64_t t = (int64_t)th * (tw / RUN) * ns;
  if (t > kMaxThreads) return cudaErrorInvalidValue;
  const int g = (C + ns * kSlot - 1) / (ns * kSlot);
  if (FLOW && g > kMaxCluster) return cudaErrorInvalidValue;
  const Layout l = layout<MD, T, FLOW>(th, tw, ns);
  if (l.total > kSmemMax) return cudaErrorInvalidValue;
  *threads = (int)t;
  *groups = g;
  *smem = l.total;
  return cudaSuccess;
}

template <int MD, class T, bool FLOW, int RUN>
cudaError_t configure() {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(corr_backward_kernel<MD, T, FLOW, RUN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

struct Launch {
  template <int MD, class T, bool FLOW, int RUN>
  static cudaError_t run(const Args& a) {
    int threads = 0, groups = 0, smem = 0;
    cudaError_t err = geometry<MD, T, FLOW, RUN>(a.C, a.tile_h, a.tile_w, a.slots, &threads,
                                                 &groups, &smem);
    if (err != cudaSuccess) return err;
    err = configure<MD, T, FLOW, RUN>();
    if (err != cudaSuccess) return err;
    const int64_t tiles_x = (a.W + a.tile_w - 1) / a.tile_w;
    const int64_t tiles_y = (a.H + a.tile_h - 1) / a.tile_h;
    if (tiles_y > 65535 || a.B > 65535 || tiles_x * groups >= (int64_t(1) << 31) ||
        (int64_t)a.C * a.H * a.W >= (int64_t(1) << 31))
      return cudaErrorInvalidConfiguration;
    // 16-byte units: a pixel's channels start 16-byte aligned in every tensor they move through
    const uintptr_t al = reinterpret_cast<uintptr_t>(a.f1) | reinterpret_cast<uintptr_t>(a.f2) |
                         reinterpret_cast<uintptr_t>(a.df1) |
                         reinterpret_cast<uintptr_t>(FLOW ? a.f1 : a.df2);
    const int vec = (int64_t)a.C * (int64_t)sizeof(T) % 16 == 0 && (al & 15) == 0;
    // d f2's float4 reductions: four channels start 16-byte aligned in the float32 buffer
    const int red = FLOW && a.C % 4 == 0 && (reinterpret_cast<uintptr_t>(a.acc) & 15) == 0;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(tiles_x * groups), (unsigned)tiles_y, (unsigned)a.B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = groups;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = FLOW && groups > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, corr_backward_kernel<MD, T, FLOW, RUN>,
                             reinterpret_cast<const T*>(a.f1), reinterpret_cast<const T*>(a.f2),
                             a.flow, a.flow_bf16, a.fs, a.scale,
                             reinterpret_cast<const T*>(a.dout), a.dout_sb, a.dout_ld,
                             reinterpret_cast<T*>(a.df1), reinterpret_cast<T*>(a.df2), a.acc,
                             a.dflow, a.ds, a.H, a.W, a.C, a.tile_h, a.tile_w, a.slots, groups,
                             vec, red);
    if (err != cudaSuccess) return err;
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
};

// {registers a thread, dynamic shared memory a block, resident blocks an
// SM (without a cluster's constraint), threads a block} of one mapping
struct Resources {
  template <int MD, class T, bool FLOW, int RUN>
  static cudaError_t run(int C, int th, int tw, int ns, int* res) {
    int threads = 0, groups = 0, smem = 0;
    cudaError_t err = geometry<MD, T, FLOW, RUN>(C, th, tw, ns, &threads, &groups, &smem);
    if (err != cudaSuccess) return err;
    err = configure<MD, T, FLOW, RUN>();
    if (err != cudaSuccess) return err;
    auto kernel = corr_backward_kernel<MD, T, FLOW, RUN>;
    cudaFuncAttributes attrs;
    err = cudaFuncGetAttributes(&attrs, kernel);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    res[0] = attrs.numRegs;
    res[1] = smem;
    res[2] = blocks;
    res[3] = threads;
    return cudaSuccess;
  }
};

template <class Op, int MD, class T, bool FLOW, class... A>
cudaError_t by_run(int run, A... a) {
  switch (run) {
    case 1: return Op::template run<MD, T, FLOW, 1>(a...);
    case 2: return Op::template run<MD, T, FLOW, 2>(a...);
    case 4: return Op::template run<MD, T, FLOW, 4>(a...);
    default: return cudaErrorInvalidValue;
  }
}

template <class Op, class T, bool FLOW, class... A>
cudaError_t by_md(int md, int run, A... a) {
  switch (md) {
    case 1: return by_run<Op, 1, T, FLOW>(run, a...);
    case 2: return by_run<Op, 2, T, FLOW>(run, a...);
    case 3: return by_run<Op, 3, T, FLOW>(run, a...);
    case 4: return by_run<Op, 4, T, FLOW>(run, a...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B2's backward: f0, f1 (B, H, W, C) float32 contiguous, dout (B, H, W,
// (2md+1)^2) float32 contiguous -> d f0, d f1 (B, H, W, C) float32. The
// flow-free case of the template, on the NHWC maps seen as channels-last
// NCHW. md in 1..4; the mapping (tile_h x tile_w pixels, run pixels and
// one slot of 8 channels a thread, slots a block) from
// ops/cuda/local_corr.py::backward_plan. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dsfm_local_correlation_backward(const void* f0, const void* f1, const void* dout,
                                               void* df0, void* df1, int B, int H, int W, int C,
                                               int md, int tile_h, int tile_w, int run, int slots,
                                               void* stream) {
  const int s2 = (2 * md + 1) * (2 * md + 1);
  Args a = {f0, f1, nullptr, 0, make_int4(0, 0, 0, 0), 0.f, dout, (int64_t)H * W * s2, s2,
            df0, df1, nullptr, nullptr, make_int4(0, 0, 0, 0), B, H, W, C, tile_h, tile_w, run,
            slots, reinterpret_cast<cudaStream_t>(stream)};
  return (int)by_md<Launch, float, false>(md, run, a);
}

// The warped correlation's backward: f1, f2 (B, C, H, W) channels-last of
// `dtype` (0 = float32, 1 = bfloat16); flow (B, 2, H, W) of `flow_dtype`,
// its element (b, k, y, x) at b fs_b + k fs_k + y fs_y + x fs_x; dout
// (B, (2md+1)^2, H, W) of `dtype`, element (b, d, y, x) at b dout_sb +
// (y W + x) dout_ld + d. Writes d f1 and d f2 (channels-last, `dtype`) and
// d flow (`flow_dtype`, strides ds_*). acc: a zeroed float32 (B, H, W, C)
// buffer, which is d f2 itself for float32 features. md in 1..4; the
// mapping as for B2's, its channel groups at most 8 (one cluster a tile).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int dsfm_warped_correlation_backward(
    const void* f1, const void* f2, const void* flow, int flow_dtype, int fs_b, int fs_k,
    int fs_y, int fs_x, float scale, const void* dout, long long dout_sb, long long dout_ld,
    void* df1, void* df2, float* acc, void* dflow, int ds_b, int ds_k, int ds_y, int ds_x, int B,
    int H, int W, int C, int md, int dtype, int tile_h, int tile_w, int run, int slots,
    void* stream) {
  if (flow_dtype != 0 && flow_dtype != 1) return (int)cudaErrorInvalidValue;
  Args a = {f1, f2, flow, flow_dtype, make_int4(fs_b, fs_k, fs_y, fs_x), scale, dout,
            (int64_t)dout_sb, (int64_t)dout_ld, df1, df2, acc, dflow,
            make_int4(ds_b, ds_k, ds_y, ds_x), B, H, W, C, tile_h, tile_w, run, slots,
            reinterpret_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)by_md<Launch, float, true>(md, run, a);
  if (dtype == 1) return (int)by_md<Launch, bf16, true>(md, run, a);
  return (int)cudaErrorInvalidValue;
}

// The resources of one mapping: `flow` 0 for B2's backward (float32 only),
// 1 for the warped one in `dtype`; res[0..3] = registers a thread, dynamic
// shared memory bytes a block, resident blocks an SM, threads a block.
// Returns a cudaError_t (0 on success).
extern "C" int dsfm_corr_backward_resources(int md, int dtype, int flow, int C, int tile_h,
                                            int tile_w, int run, int slots, int* res) {
  if (!flow) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    return (int)by_md<Resources, float, false>(md, run, C, tile_h, tile_w, slots, res);
  }
  if (dtype == 0) return (int)by_md<Resources, float, true>(md, run, C, tile_h, tile_w, slots, res);
  if (dtype == 1) return (int)by_md<Resources, bf16, true>(md, run, C, tile_h, tile_w, slots, res);
  return (int)cudaErrorInvalidValue;
}
