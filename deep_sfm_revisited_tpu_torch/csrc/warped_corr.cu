// PWC-DC's warped correlation of one level, in PWC-DC's own layout and
// dtype, written for Hopper (sm_90a).
//
// Replaces, at PWC-DC's levels 5..2, the two TPU kernels the JAX network
// reaches there (JAX models/pwcnet.py:125-131, warp_flow then
// local_correlation of the float32 casts, cast back to the network's
// dtype): deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py::
// bilinear_sample_pallas (the flow warp's gather) and
// deep_sfm_revisited_tpu/ops/pallas/local_corr.py::local_correlation_pallas
// (the windowed correlation). For f1, f2 (B, C, H, W) and a flow (B, 2, H,
// W):
//
//   out[b, (dy+md)(2md+1) + (dx+md), y, x]
//       = rnd_T( (sum_c f1[b, c, y, x] * w[b, c, y+dy, x+dx]) / C ),
//
// where w is f2 sampled at q + scale flow(q) by B1's rule (bilinear.cuh:
// `Taps`, `blend`), rounded to f2's dtype T, and zero where q is off the
// frame. f1, f2 and out share T, float32 or bfloat16, and are
// channels-last (NHWC in memory), as PWC-DC's convolutions hold its
// features (the network's input is an NHWC pair); the flow, float32 or
// bfloat16, may have any strides. Widening bfloat16 is exact and the sums
// are float32 fmaf chains in channel order, so the result is the same
// function the earlier NHWC float32 kernel computed between PWC-DC's
// permutes and casts.
//
// What bounds it on an H100 SXM: at PWC-DC's four levels of a 384x1280
// pair it reads f1, f2 and the flow once and writes the 81 channels once,
// 13.65 MB in bfloat16 (4.1 us at 3.35 TB/s), and computes ~279 MFLOP of
// bfloat16 products and sums (0.28 us at the tensor cores' 989 TFLOP/s)
// and ~20 MFLOP of float32 blends and divisions (0.3 us at 67 TFLOP/s):
// the bytes bound it. Level 2 (C = 32) alone is 9 MB. At
// these sizes a launch's fixed cost and the latency of the dependent loads
// (flow -> taps -> four-tap gathers -> sums) set most of the time, so the
// design keeps the chain short and many loads in flight.
//
// Design:
//   * Mapping. A block covers a tile of 4 output rows x 8*PX columns (PX = 1
//     or 2 adjacent pixels a thread) and has one warp per displacement row
//     dy (blockDim (8, 4, 2md+1)), so a thread holds PX x (2md+1) sums.
//     Where the tiles put too few blocks on the card the channels are split
//     across the blocks of a cluster (size 1..8 along grid.x) in groups of
//     4 channels. The Python wrapper (ops/cuda/local_corr.py::warped_plan)
//     chooses PX and the cluster size from the shape, from a measured grid
//     (tiles of 8 rows and 4 pixels a thread were no faster anywhere).
//   * Taps. The block samples a (4 + 2md) x (8 PX + 2md) halo of the warped
//     map. The taps of each halo pixel (flow read once, scaled with
//     __fmul_rn as the torch multiply rounds it) are computed once a block
//     into shared memory.
//   * Stages in T. Channels go through a ring of two shared-memory stages of
//     16 channels, both operands as 32-bit words [word][row][column], a word
//     a pixel's channel pair in bfloat16 (one channel in float32): f1's tile
//     from 16-byte loads of a pixel's channels, spread over the word planes
//     in registers; the warped halo blended in registers by the threads and
//     stored once. bfloat16 halves the stages against float32.
//   * Gathers. In channels-last memory a tap's 16 bytes are 8 bfloat16 (4
//     float32) channels of one pixel, so an item is a halo pixel's group of
//     16 bytes: four 16-byte loads, one per tap, and the blend of all its
//     channels. Items are fixed per thread across chunks; each pixel's taps
//     carry its stage offset, and addresses are 32-bit offsets within an
//     image. The loads run an item ahead of the blends, and a chunk's first
//     item (and its f1 tile) starts before the previous chunk is summed.
//     Where rows of channels are not 16-byte aligned, or a rank's channel
//     share does not start or end on a 16-byte group, the same items load
//     a channel at a time.
//   * Sums. Per word a thread reads its PX f1 words and the PX + 2md halo
//     words of its row (8-byte shared loads for PX = 2), widens them in
//     registers and feeds PX x (2md+1) fmaf chains in channel order: where
//     the plan splits the channels as B2's does, the output is bit-identical
//     to the gather, the float32 casts, B2 and the cast back. (Sums on the
//     tensor cores, mma.sync m16n8k16 over 16-pixel rows, were slower at
//     every level of both paths: the gathers and the stages, not the sums,
//     set the time.)
//   * Output. The sums meet in shared memory in NHWC tile order ([row]
//     [column][displacement]); after a barrier (a cluster's, when the
//     channels are split) rank k adds a strided share of the tile's outputs
//     in rank order through distributed shared memory, divides by C once,
//     rounds to T and writes runs of 81 TW contiguous values a tile row. No
//     atomics: two launches on the same inputs give the same bits.
//   * Host. The dynamic shared-memory attribute is set once per template
//     instantiation and device; every call is one cudaLaunchKernelEx.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"   // B1's sampling rule: Taps, blend

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileH = 4;     // output rows per block
constexpr int kCols = 8;      // thread columns per block: a quarter-warp
constexpr int kChunk = 16;    // channels per stage
constexpr int kStages = 2;
constexpr int kMaxCluster = 8;
constexpr int kMaxDevices = 64;

// How a feature type is loaded, staged and written. A halo word holds kCPW
// channels of one pixel; a 16-byte group holds kE channels (kE / kCPW
// words), kept as a uint4 as loaded.
template <class T>
struct Feat;

template <>
struct Feat<float> {
  static constexpr int kCPW = 1;
  static constexpr int kE = 4;
  __device__ __forceinline__ static uint32_t bits(const float* p) {
    return __float_as_uint(__ldg(p));
  }
  // channel k of a group
  __device__ __forceinline__ static float get(const uint4& g, int k) {
    return __uint_as_float(k == 0 ? g.x : k == 1 ? g.y : k == 2 ? g.z : g.w);
  }
  // a group from kE channels' bits (zero where absent)
  __device__ __forceinline__ static uint4 group(const uint32_t* e) {
    return make_uint4(e[0], e[1], e[2], e[3]);
  }
  // word j of a group
  __device__ __forceinline__ static uint32_t word(const uint4& g, int j) {
    return j == 0 ? g.x : j == 1 ? g.y : j == 2 ? g.z : g.w;
  }
  __device__ __forceinline__ static uint32_t pack(const float* v) { return __float_as_uint(v[0]); }
  __device__ __forceinline__ static void unpack(uint32_t w, float* v) { v[0] = __uint_as_float(w); }
  __device__ __forceinline__ static float narrow(float v) { return v; }
};

template <>
struct Feat<bf16> {
  static constexpr int kCPW = 2;
  static constexpr int kE = 8;
  __device__ __forceinline__ static uint32_t bits(const bf16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ static float get(const uint4& g, int k) {
    const uint32_t w = k < 2 ? g.x : k < 4 ? g.y : k < 6 ? g.z : g.w;
    return __uint_as_float(k % 2 == 0 ? w << 16 : w & 0xffff0000u);
  }
  __device__ __forceinline__ static uint4 group(const uint32_t* e) {
    return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                      e[6] | e[7] << 16);
  }
  // channels 2j, 2j + 1 of the group are already a word
  __device__ __forceinline__ static uint32_t word(const uint4& g, int j) {
    return j == 0 ? g.x : j == 1 ? g.y : j == 2 ? g.z : g.w;
  }
  __device__ __forceinline__ static uint32_t pack(const float* v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
  }
  __device__ __forceinline__ static void unpack(uint32_t w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static bf16 narrow(float v) { return __float2bfloat16_rn(v); }
};

template <int MD, int PX, class T>
struct Geometry {
  static constexpr int S = 2 * MD + 1;
  static constexpr int S2 = S * S;
  static constexpr int Threads = kCols * kTileH * S;   // one warp per dy row
  static constexpr int TW = kCols * PX;
  static constexpr int HH = kTileH + 2 * MD;
  static constexpr int HW = TW + 2 * MD;
  static constexpr int HWP = (HW + 3) / 4 * 4;     // halo row pitch in words: 16-byte rows
  static constexpr int CPW = Feat<T>::kCPW;
  static constexpr int E = Feat<T>::kE;            // channels of a 16-byte group
  static constexpr int KW = kChunk / CPW;          // word planes a stage (halo and f1)
  static constexpr int KG = kChunk / E;            // 16-byte groups a chunk
  static constexpr int GW = E / CPW;               // words a group
  static constexpr int HaloPlane = HH * HWP;
  static constexpr int F1Plane = kTileH * TW;
  static constexpr int HaloWords = KW * HaloPlane;
  static constexpr int StageBytes = 4 * KW * (HaloPlane + F1Plane);
  static constexpr int HaloPix = HH * HW;
  static constexpr int TapsOffset = kStages * StageBytes;
  static constexpr int LoopBytes = TapsOffset + HaloPix * 16;
  static constexpr int PartBytes = S2 * kTileH * TW * 4;   // the sums, float32
  static constexpr int SmemBytes = LoopBytes > PartBytes ? LoopBytes : PartBytes;
  // halo words a thread reads a row: PX + 2md, in PX-word vectors
  static constexpr int NW = PX + 2 * MD;
  static_assert(PX == 1 || PX == 2, "a thread's pixels are read as one 4- or 8-byte vector");
  static_assert(StageBytes % 16 == 0, "stages stay 16-byte aligned");
};

// A pixel's 16-byte group of channels [c, c + E): one 16-byte load (vec),
// else a channel at a time, zero at or past cend.
template <class T>
__device__ __forceinline__ uint4 load_group(const T* p, int c, int cend, bool vec) {
  using F = Feat<T>;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t e[F::kE];
#pragma unroll
  for (int k = 0; k < F::kE; ++k) e[k] = c + k < cend ? F::bits(p + k) : 0u;
  return F::group(e);
}

// f1's tile of one chunk as stage words [word plane][row][column] (a word:
// kCPW channels of one pixel, as the halo), through registers: `load`
// fetches a thread's 16-byte groups (a pixel's E channels) when the chunk's
// gathers start, `store` spreads each group's words over the planes after
// the sums. Channels at or past cend and pixels off the frame are zero.
template <int MD, int PX, class T>
struct F1Tile {
  using G = Geometry<MD, PX, T>;
  static constexpr int Units = kTileH * G::TW * G::KG;   // (row, column, group)
  static constexpr int PerThread = (Units + G::Threads - 1) / G::Threads;
  uint4 v[PerThread];

  __device__ __forceinline__ void load(const T* f1, int H, int W, int C, int y0, int x0, int cb,
                                       int cend, bool vec, int tid) {
#pragma unroll
    for (int u = 0; u < PerThread; ++u) {
      const int i = tid + u * G::Threads;
      if (i >= Units) break;
      const int g = i % G::KG, col = (i / G::KG) % G::TW, r = i / (G::KG * G::TW);
      const int y = y0 + r, x = x0 + col, c = cb + g * G::E;
      v[u] = y < H && x < W && c < cend
                 ? load_group(f1 + (y * W + x) * C + c, c, cend, vec)
                 : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void store(uint32_t* f1s, int tid) const {
#pragma unroll
    for (int u = 0; u < PerThread; ++u) {
      const int i = tid + u * G::Threads;
      if (i >= Units) break;
      const int g = i % G::KG, col = (i / G::KG) % G::TW, r = i / (G::KG * G::TW);
#pragma unroll
      for (int j = 0; j < G::GW; ++j)
        f1s[(g * G::GW + j) * G::F1Plane + r * G::TW + col] = Feat<T>::word(v[u], j);
    }
  }
};

// The taps of halo pixel i (row-major over HH x HW): {tap (0, 0) as the
// pixel index y W + x (0 where the pixel is off the frame); x1 - x |
// (y1 - y) << 1 | valid << 2 | on the frame << 3 | the pixel's word in a
// stage's halo plane << 4; wx, wy as bits}. The flow's element (b, k, y, x)
// is at b fs.x + k fs.y + y fs.z + x fs.w.
template <int MD, int PX, class T>
__device__ __forceinline__ int4 halo_taps(int i, const void* flow, bool flow_bf16, int4 fs,
                                          float scale, int b, int H, int W, int y0, int x0) {
  using G = Geometry<MD, PX, T>;
  const int r = i / G::HW, col = i % G::HW;
  const int gy = y0 - MD + r, gx = x0 - MD + col;
  const int where = (r * G::HWP + col) << 4;
  if (gy < 0 || gy >= H || gx < 0 || gx >= W) return make_int4(0, where, 0, 0);
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
  const Taps t(__fadd_rn((float)gx, __fmul_rn(fx, scale)),
               __fadd_rn((float)gy, __fmul_rn(fy, scale)), H, W);
  return make_int4(t.yi * W + t.xi,
                   (t.xi1 - t.xi) | ((t.yi1 - t.yi) << 1) | (t.valid != 0.f ? 4 : 0) | 8 | where,
                   __float_as_int(t.wx), __float_as_int(t.wy));
}

// The warped halo of one chunk. Item i = (halo pixel i / KG, 16-byte group
// i % KG): its E channels at the pixel's four taps, so a warp's lanes read
// a pixel's groups side by side; thread tid takes i = tid + e Threads,
// e < PerThread. The tap loads run kAhead items ahead of the blends in a
// ring of registers: `issue` starts the first kAhead items of a chunk
// (before the previous chunk is summed), `finish` starts item e + kAhead
// as it blends item e and stores its GW words, zero where the pixel is off
// the frame or the channel at or past cend.
template <int MD, int PX, class T>
struct WarpHalo {
  using G = Geometry<MD, PX, T>;
  using F = Feat<T>;
  static constexpr int Items = G::HaloPix * G::KG;
  static constexpr int PerThread = (Items + G::Threads - 1) / G::Threads;
  static constexpr int kAhead = 1;
  static constexpr int kSlots = kAhead + 1;
  uint4 raw[kSlots][4];
  int4 tap[kSlots];
  int tid;

  __device__ __forceinline__ explicit WarpHalo(int tid_) : tid(tid_) {}

  template <int E>
  __device__ __forceinline__ void fetch(const int4* taps, const T* img, int W, int C, int cb,
                                        int cend, bool vec) {
    const int i = tid + E * G::Threads;
    if (i >= Items) return;
    const int4 t = taps[i / G::KG];
    tap[E % kSlots] = t;
    const int c = cb + (i % G::KG) * G::E;
    if (c >= cend) return;
    const int dx1 = (t.y & 1) * C, dy1 = ((t.y >> 1) & 1) * W * C;
    const T* p = img + t.x * C + c;
    raw[E % kSlots][0] = load_group(p, c, cend, vec);
    raw[E % kSlots][1] = load_group(p + dx1, c, cend, vec);
    raw[E % kSlots][2] = load_group(p + dy1, c, cend, vec);
    raw[E % kSlots][3] = load_group(p + dy1 + dx1, c, cend, vec);
  }

  template <int E>
  __device__ __forceinline__ void blend_store(uint32_t* halo, int cb, int cend) const {
    const int i = tid + E * G::Threads;
    if (i >= Items) return;
    const int4 t = tap[E % kSlots];
    const int g = i % G::KG, c = cb + g * G::E;
    const float wx = __int_as_float(t.z), wy = __int_as_float(t.w);
    const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
    const float valid = (t.y & 4) ? 1.f : 0.f;
    const bool on = (t.y & 8) && c < cend;
    const uint4* v = raw[E % kSlots];
#pragma unroll
    for (int j = 0; j < G::GW; ++j) {
      float r[G::CPW];
#pragma unroll
      for (int k = 0; k < G::CPW; ++k) {
        const int ch = j * G::CPW + k;
        r[k] = blend(F::get(v[0], ch), F::get(v[1], ch), F::get(v[2], ch), F::get(v[3], ch),
                     wx, ax, wy, ay, valid);
      }
      halo[(g * G::GW + j) * G::HaloPlane + (t.y >> 4)] = on ? F::pack(r) : 0u;
    }
  }

  template <int E = 0>
  __device__ __forceinline__ void issue(const int4* taps, const T* img, int W, int C, int cb,
                                        int cend, bool vec) {
    if constexpr (E < kAhead && E < PerThread) {
      fetch<E>(taps, img, W, C, cb, cend, vec);
      issue<E + 1>(taps, img, W, C, cb, cend, vec);
    }
  }

  template <int E = 0>
  __device__ __forceinline__ void finish(uint32_t* halo, const int4* taps, const T* img, int W,
                                         int C, int cb, int cend, bool vec) {
    if constexpr (E < PerThread) {
      if constexpr (E + kAhead < PerThread) fetch<E + kAhead>(taps, img, W, C, cb, cend, vec);
      blend_store<E>(halo, cb, cend);
      finish<E + 1>(halo, taps, img, W, C, cb, cend, vec);
    }
  }
};

template <int MD, int PX, class T>
__global__ void __launch_bounds__(Geometry<MD, PX, T>::Threads, 2)
warped_corr_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                   const void* __restrict__ flow, int flow_bf16, int4 flow_strides,
                   float scale, T* __restrict__ out, int H, int W, int C, int cluster_size,
                   int vec_in) {
  using G = Geometry<MD, PX, T>;
  using F = Feat<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tx = threadIdx.x, ty = threadIdx.y, dyr = threadIdx.z;
  const int tid = tx + kCols * (ty + kTileH * dyr);
  const int rank = cluster_size > 1 ? (int)cluster.block_rank() : 0;
  const int x0 = (blockIdx.x / cluster_size) * G::TW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const int64_t image = (int64_t)b * H * W * C;   // an image's H W C < 2^31 (the launcher checks)
  const T* f1b = f1 + image;
  const T* f2b = f2 + image;

  // this rank's channel share, in groups of 4; whole 16-byte groups where
  // the share starts and ends on them
  const int groups = (C + 3) / 4;
  const int cbeg = min(C, 4 * (rank * groups / cluster_size));
  const int cend = min(C, 4 * ((rank + 1) * groups / cluster_size));
  const int nk = (cend - cbeg + kChunk - 1) / kChunk;
  const bool vec = vec_in && cbeg % G::E == 0 && cend % G::E == 0;

  auto stage_halo = [&](int s) { return reinterpret_cast<uint32_t*>(smem + s * G::StageBytes); };
  auto stage_f1 = [&](int s) {
    return reinterpret_cast<uint32_t*>(smem + s * G::StageBytes) + G::HaloWords;
  };
  int4* taps = reinterpret_cast<int4*>(smem + G::TapsOffset);

  F1Tile<MD, PX, T> f1t;
  if (0 < nk) f1t.load(f1b, H, W, C, y0, x0, cbeg, cend, vec, tid);

  // the halo's taps. In a cluster every rank computes them all: handing
  // shares around through distributed shared memory took two cluster
  // barriers and measured slower than the arithmetic it saved.
  for (int i = tid; i < G::HaloPix; i += G::Threads)
    taps[i] = halo_taps<MD, PX, T>(i, flow, flow_bf16, flow_strides, scale, b, H, W, y0, x0);
  __syncthreads();

  float acc[PX * G::S];   // [pixel][displacement dx]
#pragma unroll
  for (int k = 0; k < PX * G::S; ++k) acc[k] = 0.f;

  WarpHalo<MD, PX, T> halo(tid);
  if (0 < nk) {
    halo.issue(taps, f2b, W, C, cbeg, cend, vec);
    f1t.store(stage_f1(0), tid);
    halo.finish(stage_halo(0), taps, f2b, W, C, cbeg, cend, vec);
  }
  __syncthreads();
  for (int k = 0; k < nk; ++k) {
    const int next = k + 1;
    if (next < nk) {
      f1t.load(f1b, H, W, C, y0, x0, cbeg + next * kChunk, cend, vec, tid);
      halo.issue(taps, f2b, W, C, cbeg + next * kChunk, cend, vec);
    }
    const uint32_t* hs = stage_halo(k % kStages);
    const uint32_t* fs = stage_f1(k % kStages);
#pragma unroll
    for (int w = 0; w < G::KW; ++w) {
      // this thread's PX f1 words, then the PX + 2md halo words of its row
      const uint32_t* frow = fs + w * G::F1Plane + ty * G::TW + tx * PX;
      const uint32_t* hrow = hs + w * G::HaloPlane + (ty + dyr) * G::HWP + tx * PX;
      uint32_t fw[PX], words[G::NW];
#pragma unroll
      for (int j = 0; j < G::NW; j += PX) {
        if constexpr (PX == 2) {
          const uint2 u = *reinterpret_cast<const uint2*>(hrow + j);
          words[j] = u.x; words[j + 1] = u.y;
        } else {
          words[j] = hrow[j];
        }
      }
      if constexpr (PX == 2) {
        const uint2 u = *reinterpret_cast<const uint2*>(frow);
        fw[0] = u.x; fw[1] = u.y;
      } else {
        fw[0] = frow[0];
      }
      float a[PX][G::CPW];
#pragma unroll
      for (int p = 0; p < PX; ++p) F::unpack(fw[p], a[p]);
#pragma unroll
      for (int j = 0; j < G::NW; ++j) {
        float v[G::CPW];
        F::unpack(words[j], v);
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const int dx = j - p;
          if (dx >= 0 && dx < G::S) {
#pragma unroll
            for (int c = 0; c < G::CPW; ++c)
              acc[p * G::S + dx] = fmaf(a[p][c], v[c], acc[p * G::S + dx]);
          }
        }
      }
    }
    // stage next % kStages held chunk k - 1, whose reads ended before the
    // barrier that closed the previous iteration
    if (next < nk) {
      f1t.store(stage_f1(next % kStages), tid);
      halo.finish(stage_halo(next % kStages), taps, f2b, W, C, cbeg + next * kChunk, cend, vec);
    }
    __syncthreads();   // this chunk's reads are done and the next one's stage is written
  }

  // the sums in NHWC tile order [row][column][dy * S + dx]
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int dx = 0; dx < G::S; ++dx)
      part[(ty * G::TW + tx * PX + p) * G::S2 + dyr * G::S + dx] = acc[p * G::S + dx];
  if (cluster_size > 1) cluster.sync(); else __syncthreads();

  const float cf = (float)C;
  const int nx = min(G::TW, W - x0);
  for (int r = 0; r < kTileH; ++r) {
    const int y = y0 + r;
    if (y >= H) break;
    T* dst = out + ((int64_t)(b * H + y) * W + x0) * G::S2;
    const int off = r * G::TW * G::S2;
    for (int i = rank * G::Threads + tid; i < nx * G::S2; i += cluster_size * G::Threads) {
      float s = part[off + i];
      if (cluster_size > 1) {
        s = 0.f;
        for (int q = 0; q < cluster_size; ++q)   // fixed rank order
          s += cluster.map_shared_rank(part, q)[off + i];
      }
      dst[i] = F::narrow(s / cf);
    }
  }
  if (cluster_size > 1) cluster.sync();   // no block leaves while its partials are read
}

// One instantiation's launch: the attribute once per device, then one
// cudaLaunchKernelEx.
struct Launch {
  template <int MD, int PX, class T>
  static cudaError_t run(const void* f1, const void* f2, const void* flow, int flow_bf16,
                         int4 flow_strides, float scale, void* out, int B, int H, int W, int C,
                         int cluster_size, cudaStream_t stream) {
    using G = Geometry<MD, PX, T>;
    auto kernel = warped_corr_kernel<MD, PX, T>;
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
    const int tiles_x = (W + G::TW - 1) / G::TW, tiles_y = (H + kTileH - 1) / kTileH;
    if (tiles_y > 65535 || B > 65535 || (int64_t)C * H * W >= (int64_t(1) << 31))
      return cudaErrorInvalidConfiguration;
    // 16-byte groups: a pixel's channels start 16-byte aligned
    const uintptr_t a = reinterpret_cast<uintptr_t>(f1) | reinterpret_cast<uintptr_t>(f2);
    const int vec_in = ((int64_t)C * (int64_t)sizeof(T)) % 16 == 0 && (a & 15) == 0;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles_x * cluster_size, tiles_y, B);
    cfg.blockDim = dim3(kCols, kTileH, G::S);
    cfg.dynamicSmemBytes = G::SmemBytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster_size;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, reinterpret_cast<const T*>(f1),
                             reinterpret_cast<const T*>(f2), flow, flow_bf16, flow_strides,
                             scale, reinterpret_cast<T*>(out), H, W, C, cluster_size, vec_in);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

// One instantiation's resources: {registers a thread, dynamic shared
// memory bytes of a block, resident blocks an SM (without the cluster's
// constraint), threads a block}.
struct Resources {
  template <int MD, int PX, class T>
  static cudaError_t run(int* res) {
    using G = Geometry<MD, PX, T>;
    auto kernel = warped_corr_kernel<MD, PX, T>;
    cudaFuncAttributes attrs;
    cudaError_t err = cudaFuncGetAttributes(&attrs, kernel);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::SmemBytes);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, G::Threads,
                                                        G::SmemBytes);
    if (err != cudaSuccess) return err;
    res[0] = attrs.numRegs;
    res[1] = G::SmemBytes;
    res[2] = blocks;
    res[3] = G::Threads;
    return cudaSuccess;
  }
};

template <class Op, int MD, class T, class... A>
cudaError_t by_px(int px, A... a) {
  switch (px) {
    case 1: return Op::template run<MD, 1, T>(a...);
    case 2: return Op::template run<MD, 2, T>(a...);
    default: return cudaErrorInvalidValue;
  }
}

template <class Op, class T, class... A>
cudaError_t by_md(int md, int px, A... a) {
  switch (md) {
    case 1: return by_px<Op, 1, T>(px, a...);
    case 2: return by_px<Op, 2, T>(px, a...);
    case 3: return by_px<Op, 3, T>(px, a...);
    case 4: return by_px<Op, 4, T>(px, a...);
    default: return cudaErrorInvalidValue;
  }
}

template <class Op, class... A>
cudaError_t dispatch(int dtype, int md, int px, A... a) {
  if (dtype == 0) return by_md<Op, float>(md, px, a...);
  if (dtype == 1) return by_md<Op, bf16>(md, px, a...);
  return cudaErrorInvalidValue;
}

}  // namespace

// The warped correlation of one PWC-DC level: f1, f2 (B, C, H, W) and out
// (B, (2md+1)^2, H, W), channels-last (NHWC in memory), of `dtype` (0 =
// float32, 1 = bfloat16); flow (B, 2, H, W) of `flow_dtype` (the same
// codes), its element (b, k, y, x) at b fs_b + k fs_k + y fs_y + x fs_x;
// f2 sampled at q + scale flow(q). md in 1..4; px (pixels a thread along
// x) 1 or 2; cluster (blocks that split the channels) in 1..8 and at most
// ceil(C/4). The mapping is chosen by ops/cuda/local_corr.py::warped_plan.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dsfm_warped_correlation(const void* f1, const void* f2, const void* flow,
                                       int flow_dtype, int fs_b, int fs_k, int fs_y, int fs_x,
                                       float scale, void* out, int B, int H, int W, int C, int md,
                                       int px, int cluster, int dtype, void* stream) {
  if (flow_dtype != 0 && flow_dtype != 1) return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || cluster > (C + 3) / 4)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<Launch>(dtype, md, px, f1, f2, flow, flow_dtype,
                               make_int4(fs_b, fs_k, fs_y, fs_x), scale, out, B, H, W, C,
                               cluster, reinterpret_cast<cudaStream_t>(stream));
}

// The resources of the mapping (md, px) in `dtype`: res[0..3] = registers
// a thread, dynamic shared memory bytes a block, resident blocks an SM,
// threads a block. Returns a cudaError_t (0 on success).
extern "C" int dsfm_warped_correlation_resources(int md, int px, int dtype, int* res) {
  return (int)dispatch<Resources>(dtype, md, px, res);
}
