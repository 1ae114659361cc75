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
// 8 us at 3.35 TB/s; level 2 alone is 17.8 MB (5.3 us). The arithmetic is
// ~282 MFLOP, about 4 us at 67 TFLOP/s float32. Levels 6..3 move under
// 7 MB each, so there a launch's fixed cost and the latency of the loads
// set the time, not the bytes: the design has to put enough warps in
// flight at every level and keep loads in flight behind the arithmetic.
//
// Design:
//   * Mapping. A block covers a tile of 4 output rows x 8*PX columns
//     (PX = 1, 2 or 4 horizontally adjacent pixels per thread) and has one
//     warp per displacement row dy (blockDim (8, 4, 2md+1)): the dy split is
//     across the block's warps, so each thread holds PX x (2md+1) sums
//     (36 at most), not 81. Where the tiles put too few warps on the card,
//     PX narrows first (more, smaller tiles); where one pixel per thread
//     still falls short, the channels are split across the blocks of a
//     thread-block cluster (cluster size 1..8 along grid.x): rank k sums the
//     channel groups [k G / n, (k+1) G / n) of the G = ceil(C/4) groups of
//     4. The Python wrapper (ops/cuda/local_corr.py::plan) picks PX and the
//     cluster size from (B, H, W, C, md) and passes them here; it aims at
//     ~1000 warps (432 at PWC-DC's level 6, 120 pixels, against 8 before).
//     Narrowing comes first because the cluster's barriers and its
//     reduction cost more than the smaller tiles' extra halo reads.
//   * Staging. Each block walks its channel share in chunks of 16 through
//     a ring of kStages = 2 shared-memory stages: cp.async copies chunk k+1
//     while chunk k is summed. A stage holds the f1 halo (tile + md on every side)
//     and the f0 tile, channel-group-major ([group of 4][row][column] as
//     float4). Off-frame halo pixels and channels past the share use the
//     zero-fill form (source size 0), so the border costs nothing in the
//     inner loop and there is no padded copy of f1 in device memory. Warps
//     take rows and lanes take (column, group) pairs, so the index
//     arithmetic is shifts and masks, with no integer division per element.
//     Where C is not a multiple of 4 or a pointer is not 16-byte aligned,
//     the same kernel stages with 4-byte cp.async per channel instead of 16.
//   * Bank conflicts. A quarter-warp (8 threads of one tile row) reads
//     float4s at columns t*PX + j; one float4 of padding after every PX
//     columns puts those 8 reads on 8 distinct 16-byte bank groups, so
//     every float4 read of the inner loop is conflict-free for PX = 1, 2, 4.
//   * Reuse. Per group of 4 channels a thread keeps its PX f0 values in
//     registers and reads the PX + 2md f1 values of its row once each; each
//     feeds up to PX x 4 FMAs from a register (for PX = 4: 144 FMAs per 16
//     float4 shared loads).
//   * Reduction. Sums are fmaf chains in channel order. Each block writes
//     its partial sums to shared memory in NHWC tile order; after a cluster
//     barrier, rank k reduces a strided share of the tile's outputs by
//     adding the ranks' partials in rank order 0..n-1 through distributed
//     shared memory, divides by C once and writes coalesced NHWC runs. No
//     atomics: two launches on the same inputs give the same bits.
//   * Host. The dynamic shared-memory attribute is set once per template
//     instantiation and device; every call is one cudaLaunchKernelEx.
//
// dsfm_warped_correlation -- the same correlation with its f1 operand
// warped: f1[b, q] is the bilinear sample of the features f2 (B, H, W, C),
// float32 or bfloat16, at q + scale flow(q) by B1's rule (bilinear.cuh:
// `Taps`, `blend`), rounded to f2's dtype, and zero where q is off the
// frame. It is PWC-DC's flow warp and correlation at levels 5..2 in one
// launch (JAX models/pwcnet.py:125-131: warp_flow, then local_correlation
// of the float32 casts), and also replaces B1's gather there
// (deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py::bilinear_sample_pallas):
// the warped map never reaches device memory. Mapping, clusters, f0's
// staging and the fixed-order sums are B2's; only the halo changes. The
// block first computes the taps of every halo pixel once into shared memory
// (flow read once, scale applied with __fmul_rn as the torch multiply
// rounds it); then per chunk each thread fetches the four taps' 4-channel
// groups of its halo elements (8 bytes each in bfloat16), blends, rounds
// and stores them to the stage as float32. A chunk's fetches for up to
// kHeld elements a thread are issued before the previous chunk is summed
// and blended after it, so the ring still overlaps loads with arithmetic.
// The stage then holds the very values the composition (gather, cast, B2)
// staged, so the output is the same bits. What bounds it: at PWC-DC's
// levels 5..2 it reads f1 (float32), f2 and the flow once and writes the
// 81 channels once, a few MB a level; as for B2, a launch's fixed cost and
// the load latency, not the bytes, set its time there.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bilinear.cuh"   // B1's sampling rule: Taps, blend

namespace cg = cooperative_groups;

namespace {

constexpr int kTileH = 4;    // output rows per block
constexpr int kCols = 8;     // thread columns per block: a quarter-warp
constexpr int kChunk = 16;   // channels per stage
constexpr int kChunk4 = kChunk / 4;
constexpr int kStages = 2;
constexpr int kMaxCluster = 8;
constexpr int kMaxDevices = 64;

// physical float4 column of logical column c: one float4 of padding after
// every PX columns (none for PX = 1)
template <int PX>
__host__ __device__ constexpr int pcol(int c) {
  return PX == 1 ? c : c + c / PX;
}

template <int MD, int PX>
struct Geometry {
  static constexpr int S = 2 * MD + 1;
  static constexpr int S2 = S * S;
  static constexpr int Threads = kCols * kTileH * S;   // one warp per dy row
  static constexpr int TileW = kCols * PX;
  static constexpr int HaloH = kTileH + 2 * MD;
  static constexpr int HaloW = TileW + 2 * MD;
  static constexpr int HaloPW = pcol<PX>(HaloW - 1) + 1;
  static constexpr int F0PW = pcol<PX>(TileW - 1) + 1;
  static constexpr int F1Plane = HaloH * HaloPW;        // float4 per channel group
  static constexpr int F0Plane = kTileH * F0PW;
  static constexpr int StageF4 = kChunk4 * (F1Plane + F0Plane);
  static constexpr int OutFloats = kTileH * TileW * S2;
  static constexpr int StageBytes = kStages * StageF4 * 16;
  static constexpr int SmemBytes = StageBytes > OutFloats * 4 ? StageBytes : OutFloats * 4;
  // the warped entry: one int4 of taps a halo pixel after the stages
  static constexpr int HaloPix = HaloH * HaloW;
  static constexpr int HaloElems = HaloPix * kChunk4;   // (pixel, group of 4) a chunk
  static constexpr int WarpBytes = StageBytes + HaloPix * 16;
  static constexpr int WarpSmemBytes = WarpBytes > OutFloats * 4 ? WarpBytes : OutFloats * 4;
};

// Where the f1 operand comes from. Plain: B2 stages the given float32 map.
// WarpF32, WarpBF16: the warped entry samples f2 of that dtype; a Group is
// one tap's 4 channels as loaded, kHeld the halo elements a thread keeps
// in registers across a sum (32 registers of raw taps either way).
struct Plain {
  static constexpr bool kWarp = false;
  static constexpr int kBytes = 4;
};

struct WarpF32 {
  static constexpr bool kWarp = true;
  static constexpr int kBytes = 4;
  static constexpr int kHeld = 2;
  using Group = float4;
  __device__ __forceinline__ static Group load(const char* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  // channels [0, n) of the group, n in 1..4; the rest zero
  __device__ __forceinline__ static Group load_n(const char* p, int n) {
    const float* f = reinterpret_cast<const float*>(p);
    return make_float4(__ldg(f), n > 1 ? __ldg(f + 1) : 0.f, n > 2 ? __ldg(f + 2) : 0.f,
                       n > 3 ? __ldg(f + 3) : 0.f);
  }
  __device__ __forceinline__ static void unpack(const Group& g, float* v) {
    v[0] = g.x; v[1] = g.y; v[2] = g.z; v[3] = g.w;
  }
  __device__ __forceinline__ static float round(float v) { return v; }
};

struct WarpBF16 {
  static constexpr bool kWarp = true;
  static constexpr int kBytes = 2;
  static constexpr int kHeld = 4;
  using Group = uint2;
  __device__ __forceinline__ static Group load(const char* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static Group load_n(const char* p, int n) {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    const uint32_t a = __ldg(u), b = n > 1 ? __ldg(u + 1) : 0u;
    const uint32_t c = n > 2 ? __ldg(u + 2) : 0u, d = n > 3 ? __ldg(u + 3) : 0u;
    return make_uint2(a | (b << 16), c | (d << 16));
  }
  __device__ __forceinline__ static void unpack(const Group& g, float* v) {
    v[0] = __uint_as_float(g.x << 16); v[1] = __uint_as_float(g.x & 0xffff0000u);
    v[2] = __uint_as_float(g.y << 16); v[3] = __uint_as_float(g.y & 0xffff0000u);
  }
  // the sample as the gather stores it in bfloat16, read back as float32
  __device__ __forceinline__ static float round(float v) {
    return __uint_as_float((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v)) << 16);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start the copies of channels [cb, cb + kChunk) of the f1 halo (HALO) and
// the f0 tile into one stage; channels at or past cend, and pixels off the
// frame, are zero-filled. Rows 0..HaloH-1 are the halo, the next kTileH the
// f0 tile.
template <int MD, int PX, bool HALO>
__device__ __forceinline__ void stage(float4* buf, const float* f0, const float* f1,
                                      int64_t img, int H, int W, int C, int y0, int x0,
                                      int cb, int cend, bool vec, int warp, int lane) {
  using G = Geometry<MD, PX>;
  for (int r = (HALO ? 0 : G::HaloH) + warp; r < G::HaloH + kTileH; r += G::S) {
    const bool halo = r < G::HaloH;
    const int gy = halo ? y0 - MD + r : y0 + r - G::HaloH;
    const int width = halo ? G::HaloW : G::TileW;
    const int gx0 = halo ? x0 - MD : x0;
    const int plane = halo ? G::F1Plane : G::F0Plane;
    const float* src = halo ? f1 : f0;
    float4* dst = halo ? buf + r * G::HaloPW
                       : buf + kChunk4 * G::F1Plane + (r - G::HaloH) * G::F0PW;
    const bool row_in = gy >= 0 && gy < H;
    const int64_t row = (img + (int64_t)(row_in ? gy : 0) * W) * C;
    if (vec) {
      for (int e = lane; e < width * kChunk4; e += 32) {
        const int col = e / kChunk4, g = e % kChunk4;   // kChunk4 = 4: shift, mask
        const int gx = gx0 + col, c = cb + 4 * g;
        const bool ok = row_in && gx >= 0 && gx < W && c < cend;
        cp_async16(dst + g * plane + pcol<PX>(col), ok ? src + row + (int64_t)gx * C + c : src, ok);
      }
    } else {
      for (int e = lane; e < width * kChunk; e += 32) {
        const int col = e / kChunk, ch = e % kChunk;     // kChunk = 16: shift, mask
        const int gx = gx0 + col, c = cb + ch;
        const bool ok = row_in && gx >= 0 && gx < W && c < cend;
        float* d = reinterpret_cast<float*>(dst + (ch / 4) * plane + pcol<PX>(col)) + ch % 4;
        cp_async4(d, ok ? src + row + (int64_t)gx * C + c : src, ok);
      }
    }
  }
}

// The warped entry's halo taps, once a block: per halo pixel (row-major)
// {tap (0, 0) as y W + x, or -1 off the frame; x1 - x | (y1 - y) << 1 |
// valid << 2; wx, wy as bits}, from the flow at the pixel times `scale`.
template <int MD, int PX>
__device__ __forceinline__ void warp_taps(int4* taps, const float* flow, float scale, int b,
                                          int H, int W, int y0, int x0, int tid) {
  using G = Geometry<MD, PX>;
  const int64_t hw = (int64_t)H * W;
  const float* fb = flow + (int64_t)b * 2 * hw;
  for (int i = tid; i < G::HaloPix; i += G::Threads) {
    const int gy = y0 - MD + i / G::HaloW, gx = x0 - MD + i % G::HaloW;
    int4 t4 = make_int4(-1, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int64_t q = (int64_t)gy * W + gx;
      // the coordinate as grid + flow * scale rounds it
      const Taps t(__fadd_rn((float)gx, __fmul_rn(__ldg(fb + q), scale)),
                   __fadd_rn((float)gy, __fmul_rn(__ldg(fb + hw + q), scale)), H, W);
      t4 = make_int4(t.yi * W + t.xi,
                     (t.xi1 - t.xi) | ((t.yi1 - t.yi) << 1) | (t.valid != 0.f ? 4 : 0),
                     __float_as_int(t.wx), __float_as_int(t.wy));
    }
    taps[i] = t4;
  }
}

// The warped halo of one chunk: element i = (halo pixel i / 4, channel
// group i % 4), thread tid takes i = tid + e Threads. `issue` starts the
// tap fetches of the first kHeld elements into registers, `finish` blends
// those and fetches, blends and stores the rest: each element's 4 channels,
// rounded to the features' dtype, as one float4 of the stage, zero off the
// frame and past cend.
template <int MD, int PX, class Src>
struct WarpHalo {
  using G = Geometry<MD, PX>;
  using Group = typename Src::Group;
  static constexpr int kPer = (G::HaloElems + G::Threads - 1) / G::Threads;
  static constexpr int kHeld = kPer < Src::kHeld ? kPer : Src::kHeld;
  Group raw[kHeld][4];

  __device__ __forceinline__ static void fetch(Group* v, const int4& t, const char* img, int W,
                                               int C, int c, int cend, bool vec) {
    const int64_t o00 = t.x, o01 = o00 + (t.y & 1);
    const int64_t o10 = o00 + ((t.y >> 1) & 1) * (int64_t)W, o11 = o10 + (t.y & 1);
    const int64_t o[4] = {o00, o01, o10, o11};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const char* p = img + (o[k] * C + c) * Src::kBytes;
      v[k] = vec ? Src::load(p) : Src::load_n(p, cend - c);
    }
  }

  __device__ __forceinline__ static float4 blend4(const Group* v, const int4& t) {
    float a[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) Src::unpack(v[k], a[k]);
    const float wx = __int_as_float(t.z), wy = __int_as_float(t.w);
    const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
    const float valid = (t.y & 4) ? 1.f : 0.f;
    float r[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      r[ch] = Src::round(blend(a[0][ch], a[1][ch], a[2][ch], a[3][ch], wx, ax, wy, ay, valid));
    return make_float4(r[0], r[1], r[2], r[3]);
  }

  __device__ __forceinline__ void issue(const int4* taps, const char* img, int W, int C, int cb,
                                        int cend, bool vec, int tid) {
#pragma unroll
    for (int e = 0; e < kHeld; ++e) {
      const int i = tid + e * G::Threads;
      if (i >= G::HaloElems) break;
      const int4 t = taps[i >> 2];
      const int c = cb + 4 * (i & 3);
      if (t.x >= 0 && c < cend) fetch(raw[e], t, img, W, C, c, cend, vec);
    }
  }

  __device__ __forceinline__ void finish(float4* buf, const int4* taps, const char* img, int W,
                                         int C, int cb, int cend, bool vec, int tid) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = tid + e * G::Threads;
      if (i >= G::HaloElems) break;
      const int pix = i >> 2, g = i & 3;
      const int4 t = taps[pix];
      const int c = cb + 4 * g;
      float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t.x >= 0 && c < cend) {
        if (e < kHeld) {
          r = blend4(raw[e], t);
        } else {
          Group v[4];
          fetch(v, t, img, W, C, c, cend, vec);
          r = blend4(v, t);
        }
      }
      buf[g * G::F1Plane + (pix / G::HaloW) * G::HaloPW + pcol<PX>(pix % G::HaloW)] = r;
    }
  }
};

struct NoHalo {};

// f1 is B2's float32 f1 (Plain) or the features to warp (the warped entry,
// with flow (B, 2, H, W) float32 and its scale).
template <int MD, int PX, class Src>
__global__ void __launch_bounds__(Geometry<MD, PX>::Threads)
local_corr_kernel(const float* __restrict__ f0, const void* __restrict__ f1,
                  const float* __restrict__ flow, float scale, float* __restrict__ out, int H,
                  int W, int C, int cluster_size, int vec) {
  using G = Geometry<MD, PX>;
  extern __shared__ float4 smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tx = threadIdx.x, ty = threadIdx.y, dyr = threadIdx.z;  // dyr: the warp
  const int tid = tx + kCols * (ty + kTileH * dyr);
  const int lane = tid & 31;
  const int rank = cluster_size > 1 ? (int)cluster.block_rank() : 0;
  const int x0 = (blockIdx.x / cluster_size) * G::TileW, y0 = blockIdx.y * kTileH;
  const int64_t img = (int64_t)blockIdx.z * H * W;

  // this rank's channel share, in groups of 4
  const int groups = (C + 3) / 4;
  const int cbeg = min(C, 4 * (rank * groups / cluster_size));
  const int cend = min(C, 4 * ((rank + 1) * groups / cluster_size));
  const int nk = (cend - cbeg + kChunk - 1) / kChunk;

  float acc[PX][G::S];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int k = 0; k < G::S; ++k) acc[p][k] = 0.f;

  // first float4 column of this thread's pixels, in the padded layout
  const int base = PX == 1 ? tx : tx * (PX + 1);
  const float* f1s_src = Src::kWarp ? nullptr : reinterpret_cast<const float*>(f1);
  const char* f2 = reinterpret_cast<const char*>(f1) + img * C * Src::kBytes;
  int4* taps = reinterpret_cast<int4*>(smem + kStages * G::StageF4);

  // ring of kStages stages: chunk k lives in stage k % kStages; one commit
  // group per chunk (possibly empty), so waiting until kStages - 1 groups
  // are pending means chunk k has landed. The warped entry's halo is
  // written by the threads themselves: chunk 0's before the loop, chunk
  // k + 1's after chunk k is summed (its fetches issued before the sum).
  static_assert(kStages == 2, "the warped halo's ring assumes two stages");
  if (0 < nk)
    stage<MD, PX, !Src::kWarp>(smem, f0, f1s_src, img, H, W, C, y0, x0, cbeg, cend, vec, dyr,
                               lane);
  cp_async_commit();
  [[maybe_unused]] std::conditional_t<Src::kWarp, WarpHalo<MD, PX, Src>, NoHalo> halo_;
  if constexpr (Src::kWarp) {
    warp_taps<MD, PX>(taps, flow, scale, blockIdx.z, H, W, y0, x0, tid);
    __syncthreads();
    if (0 < nk) {
      halo_.issue(taps, f2, W, C, cbeg, cend, vec, tid);
      halo_.finish(smem, taps, f2, W, C, cbeg, cend, vec, tid);
    }
  }
  for (int k = 0; k < nk; ++k) {
    const int next = k + kStages - 1;
    if (next < nk) {
      stage<MD, PX, !Src::kWarp>(smem + (next % kStages) * G::StageF4, f0, f1s_src, img, H, W,
                                 C, y0, x0, cbeg + next * kChunk, cend, vec, dyr, lane);
      if constexpr (Src::kWarp)
        halo_.issue(taps, f2, W, C, cbeg + next * kChunk, cend, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float4* f1s = smem + (k % kStages) * G::StageF4;
    const float4* f0s = f1s + kChunk4 * G::F1Plane;
#pragma unroll
    for (int g = 0; g < kChunk4; ++g) {
      const float4* f0row = f0s + g * G::F0Plane + ty * G::F0PW + base;
      const float4* f1row = f1s + g * G::F1Plane + (ty + dyr) * G::HaloPW + base;
      float4 a[PX];
#pragma unroll
      for (int p = 0; p < PX; ++p) a[p] = f0row[p];
#pragma unroll
      for (int j = 0; j < PX + 2 * MD; ++j) {
        const float4 v = f1row[pcol<PX>(j)];
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const int dx = j - p;
          if (dx >= 0 && dx < G::S) {
            float s = acc[p][dx];
            s = fmaf(a[p].x, v.x, s);
            s = fmaf(a[p].y, v.y, s);
            s = fmaf(a[p].z, v.z, s);
            s = fmaf(a[p].w, v.w, s);
            acc[p][dx] = s;
          }
        }
      }
    }
    if constexpr (Src::kWarp) {
      // stage next % kStages held chunk k - 1, whose reads ended before the
      // barrier that closed the previous iteration
      if (next < nk)
        halo_.finish(smem + (next % kStages) * G::StageF4, taps, f2, W, C, cbeg + next * kChunk,
                     cend, vec, tid);
    }
    __syncthreads();   // every read of this stage is done before it is refilled
  }
  cp_async_wait<0>();

  // partial sums in NHWC tile order: [row][column][dy * S + dx]
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int k = 0; k < G::S; ++k)
      part[(ty * G::TileW + tx * PX + p) * G::S2 + dyr * G::S + k] = acc[p][k];
  if (cluster_size > 1) cluster.sync(); else __syncthreads();

  const float cf = (float)C;
  const int nx = min(G::TileW, W - x0);
  for (int r = 0; r < kTileH; ++r) {
    const int y = y0 + r;
    if (y >= H) break;
    float* dst = out + (img + (int64_t)y * W + x0) * G::S2;
    const int off = r * G::TileW * G::S2;
    for (int i = rank * G::Threads + tid; i < nx * G::S2; i += cluster_size * G::Threads) {
      float s = part[off + i];
      if (cluster_size > 1) {
        s = 0.f;
        for (int q = 0; q < cluster_size; ++q)   // fixed rank order
          s += cluster.map_shared_rank(part, q)[off + i];
      }
      dst[i] = s / cf;
    }
  }
  if (cluster_size > 1) cluster.sync();   // no block leaves while its partials are read
}

template <int MD, int PX, class Src>
cudaError_t launch(const float* f0, const void* f1, const float* flow, float scale, float* out,
                   int B, int H, int W, int C, int cluster_size, int vec, cudaStream_t stream) {
  using G = Geometry<MD, PX>;
  constexpr int smem_bytes = Src::kWarp ? G::WarpSmemBytes : G::SmemBytes;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(local_corr_kernel<MD, PX, Src>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int tiles_x = (W + G::TileW - 1) / G::TileW, tiles_y = (H + kTileH - 1) / kTileH;
  if (tiles_y > 65535 || B > 65535) return cudaErrorInvalidConfiguration;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_x * cluster_size, tiles_y, B);
  cfg.blockDim = dim3(kCols, kTileH, G::S);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, local_corr_kernel<MD, PX, Src>, f0, f1, flow, scale, out, H, W,
                           C, cluster_size, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MD, class Src>
cudaError_t launch_px(const float* f0, const void* f1, const float* flow, float scale,
                      float* out, int B, int H, int W, int C, int px, int cluster_size, int vec,
                      cudaStream_t stream) {
  switch (px) {
    case 1: return launch<MD, 1, Src>(f0, f1, flow, scale, out, B, H, W, C, cluster_size, vec, stream);
    case 2: return launch<MD, 2, Src>(f0, f1, flow, scale, out, B, H, W, C, cluster_size, vec, stream);
    case 4: return launch<MD, 4, Src>(f0, f1, flow, scale, out, B, H, W, C, cluster_size, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <class Src>
cudaError_t launch_md(const float* f0, const void* f1, const float* flow, float scale,
                      float* out, int B, int H, int W, int C, int md, int px, int cluster,
                      int vec, cudaStream_t s) {
  if (cluster < 1 || cluster > kMaxCluster || cluster > (C + 3) / 4) return cudaErrorInvalidValue;
  switch (md) {
    case 1: return launch_px<1, Src>(f0, f1, flow, scale, out, B, H, W, C, px, cluster, vec, s);
    case 2: return launch_px<2, Src>(f0, f1, flow, scale, out, B, H, W, C, px, cluster, vec, s);
    case 3: return launch_px<3, Src>(f0, f1, flow, scale, out, B, H, W, C, px, cluster, vec, s);
    case 4: return launch_px<4, Src>(f0, f1, flow, scale, out, B, H, W, C, px, cluster, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// f0, f1 (B, H, W, C) float32 contiguous; out (B, H, W, (2md+1)^2) float32.
// md in 1..4; px (pixels per thread along x) in {1, 2, 4}; cluster (blocks
// that split the channels) in 1..8 and at most ceil(C/4). The mapping is
// chosen by ops/cuda/local_corr.py::plan. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dsfm_local_correlation(const void* f0, const void* f1, void* out, int B,
                                      int H, int W, int C, int md, int px, int cluster,
                                      void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(f0) | reinterpret_cast<uintptr_t>(f1)) & 15) == 0;
  return (int)launch_md<Plain>(reinterpret_cast<const float*>(f0), f1, nullptr, 0.f,
                               reinterpret_cast<float*>(out), B, H, W, C, md, px, cluster,
                               C % 4 == 0 && aligned, reinterpret_cast<cudaStream_t>(stream));
}

// The warped correlation: out (B, H, W, (2md+1)^2) float32 of f1 (B, H, W,
// C) float32 and f2 (B, H, W, C) of `dtype` (0 = float32, 1 = bfloat16)
// sampled at q + scale flow(q), flow (B, 2, H, W) float32; all contiguous.
// The same md, px and cluster rules as dsfm_local_correlation, whose plan
// it takes.
extern "C" int dsfm_warped_correlation(const void* f1, const void* f2, const void* flow,
                                       float scale, void* out, int B, int H, int W, int C,
                                       int md, int px, int cluster, int dtype, void* stream) {
  const float* a = reinterpret_cast<const float*>(f1);
  const float* fl = reinterpret_cast<const float*>(flow);
  float* o = reinterpret_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uintptr_t a16 = reinterpret_cast<uintptr_t>(f1) & 15, p2 = reinterpret_cast<uintptr_t>(f2);
  if (dtype == 0)
    return (int)launch_md<WarpF32>(a, f2, fl, scale, o, B, H, W, C, md, px, cluster,
                                   C % 4 == 0 && a16 == 0 && (p2 & 15) == 0, s);
  if (dtype == 1)
    return (int)launch_md<WarpBF16>(a, f2, fl, scale, o, B, H, W, C, md, px, cluster,
                                    C % 4 == 0 && a16 == 0 && (p2 & 7) == 0, s);
  return (int)cudaErrorInvalidValue;
}
