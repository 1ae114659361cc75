// Kernels R1 and R2: RAFT's correlation lookup and its backward, written
// for Hopper (sm_90a).
//
// There is no TPU kernel behind them: the JAX package computes the lookup
// (deep_sfm_revisited_tpu/models/raft.py::lookup_correlation, :127-181) as
// XLA one-hot matmuls over a pre-padded pyramid, and its gradient as their
// transposes. The semantics, for a query q with coordinates (x, y) at 1/8
// resolution, a level l of size (Hl, Wl) and radius r:
//
//   cx = clip(x / 2^l, -(r+2), Wl+r+1), cy likewise with Hl,
//   x0 = floor(cx - r), fx = (cx - r) - x0, y0 and fy likewise,
//   p[s][t] = level[q, y0+s, x0+t] for s, t in 0..2r+1, zero off the level,
//   win[dy][dx] = (1-fy)(1-fx) p[dy][dx] + (1-fy) fx p[dy][dx+1]
//               + fy (1-fx) p[dy+1][dx] + fy fx p[dy+1][dx+1]   (float32),
//   out[q, l (2r+1)^2 + dx (2r+1) + dy] = win[dy][dx]   (dx-major).
//
// R1 (dsfm_raft_lookup) writes out (Q, L (2r+1)^2) in the network's dtype
// (float32 or bfloat16) from the levels (Q, Hl, Wl), bfloat16 as RAFT
// stores them (float32 is taken too), and the float32 coordinates (Q, 2).
// R2 (dsfm_raft_lookup_backward) takes dout of that shape and adds the
// patch gradient of every (query, level) into one accumulator a level,
// (Q, Hl, Wl) in the levels' dtype, which the caller zero-fills once a
// backward pass (RAFT's iterations add into one pyramid gradient), each
// element as
//
//   buf = round(float(buf) + float(round(d p)))   (round: to the levels' dtype),
//
// which is what adding the iterations' dense gradients in that dtype gives;
// and writes the coordinates' gradient (Q, 2) float32:
//
//   d p[s][t] = w11 g[s-1][t-1] + w10 g[s-1][t] + w01 g[s][t-1] + w00 g[s][t]
//               (absent terms skipped; added in that order in float32, the
//               order in which JAX's transpose adds the patch's cotangents),
//   d x = sum_l clip'(x / 2^l) (dfx_l - d(1-fx)_l) / 2^l, d y likewise,
//
// with g = dout as float32 and clip' 1 inside the clip, 1/2 on its bounds
// (jax.vjp of jnp.clip splits a tie), 0 beyond them.
//
// What bounds them on an H100 SXM: device-memory bytes. R1 at a 384x1280
// eval pair (Q = 7680, levels 48x160 .. 6x20) writes 4.98 MB and reads at
// most a 10x10 patch of each level a query (200 bytes in bfloat16, in 10
// rows of 20 bytes; a row straddles two 32-byte sectors more often than
// not, so at the sectors' granularity the taps cost ~2.5x their bytes). R2
// at a b = 4, 256x768 training step (Q = 12288) reads dout (7.96 MB), the
// in-frame taps (<= 7.9 MB) and the coordinates, and reads and writes the
// patches' rows of the accumulators (<= 15.7 MB): ~32 MB a launch. The
// arithmetic is a few hundred operations a (query, level).
//
// Design. A first redesign, one warp a query walking the four levels and
// eight queries a block, timed no faster on an H100 than one block a query,
// and hardly faster without its tap loads: it was bound by instructions
// issued, not by memory (every lane computed every level's window and tap
// addresses, a warp's 32 lanes for one query's 4 x 81 outputs). So a
// thread takes one row of one level of one query:
//   * Mapping. A block takes QPB consecutive queries (the last block may
//     hold fewer: Q is not always a multiple of QPB), with L_max (2r+1)
//     threads a query in R1, thread (l, dy) computing row dy of level l's
//     window (2r+1 outputs), and L_max (2r+2) in R2, thread (l, s) taking
//     patch row s of level l (its d p row, its accumulator row and, for s
//     < 2r+1, window row s's share of the coordinates' gradient). QPB is
//     kR1Queries (4) in R1 and kR2Queries (2) in R2, chosen by timing 4, 8
//     and 16 (R1) and 2, 4 and 8 (R2) on an H100 at RAFT's eval and
//     training shapes (raft_compare.py; PERF.md).
//   * Loads in flight. Each thread reads its query's coordinates (a warp's
//     threads read the same few 8-byte pairs, one request) with no barrier
//     before it, computes its level's window and issues all its tap loads
//     (R1: patch rows dy and dy+1; R2: rows s and s+1, and the two rows of
//     dout's window its d p row needs, a level's threads reading
//     consecutive elements) before it uses any. A patch row is read as the aligned 4-byte words that
//     hold its in-frame taps (bfloat16 pairs: S/2 + 1 words a row of S =
//     2r+2 taps, shifted into place by a funnel shift where the row starts
//     on a word's upper half; a float32 level one tap a word); a word with
//     no in-frame tap is not read, and taps off the level are 0. R2 issues
//     the accumulator words it will update in the same burst.
//   * R1's stores. The block's output is staged in shared memory and
//     written as the block's contiguous span of out in 16-byte units (8
//     queries: 8 x 648 B = 324 units in bfloat16), elements at the tail.
//   * R2's accumulation. A query's rows belong to its threads alone, so
//     they add without atomics: a read-modify-write of each aligned word
//     that holds a patch tap on the level, each word by one thread (the
//     thread of the patch row that holds the word's first patch element;
//     it reads a neighbouring row's d p from shared memory where the word
//     straddles two rows), and a word that straddles the patch's edge
//     writes its other element back unchanged. Where a word could hold two
//     queries' elements (bfloat16 with Hl Wl odd, or an accumulator that is
//     not 4-byte aligned) the row's thread updates element by element.
//   * Rounding. Every float32 operation of the window and of d p is rounded
//     on its own (__fmul_rn, __fadd_rn, __fsub_rn forbid FMA contraction)
//     in the order of the plain PyTorch versions (models/raft.py::
//     lookup_correlation_plain, lookup_correlation_backward_plain), so R1
//     gives their bits, and R2's accumulator the bits of the dense
//     gradients added in the levels' dtype, last iteration first. The
//     coordinates' gradient sums 9 products a window row in dx order, the
//     rows in dy order (a level's first thread) and the levels in order
//     (the query's first thread): deterministic, not the plain version's
//     order.
//   * Parameters. The level table is a `__grid_constant__` kernel
//     parameter, read in place.
//
// Host interface: plain C launchers (the operators of raft_lookup_ops.cpp
// call them). The level pointers, heights and widths arrive as host arrays
// and travel to the kernel in a struct passed by value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxLevels = 4;
// Queries a block (QPB) of R1 and R2 at every radius.
constexpr int kR1Queries = 4;
constexpr int kR2Queries = 2;

struct Levels {
  const void* ptr[kMaxLevels];
  void* grad[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int n;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

// Element h of a 4-byte word of T, and the word with element h replaced.
template <typename T>
struct Word;
template <>
struct Word<bf16> {
  static constexpr int E = 2;
  __device__ static float get(unsigned w, int h) {
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> (16 * h))));
  }
  __device__ static unsigned set(unsigned w, int h, float v) {
    const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    return h ? ((w & 0xffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
  }
};
template <>
struct Word<float> {
  static constexpr int E = 1;
  __device__ static float get(unsigned w, int) { return __uint_as_float(w); }
  __device__ static unsigned set(unsigned, int, float v) { return __float_as_uint(v); }
};

// The window of one (query, level): clip, corner and weights, as the plain
// version computes them in float32.
struct Window {
  int x0, y0;
  float fx, fy, gx, gy;   // gx = 1 - fx, gy = 1 - fy
  float mx, my;           // clip' of x and y: 1, 0.5 or 0
};

__device__ __forceinline__ Window make_window(float x, float y, float scale, int Hl, int Wl,
                                              int r) {
  Window win;
  x = __fmul_rn(x, scale);
  y = __fmul_rn(y, scale);
  const float lo = -(float)(r + 2);
  const float hx = (float)(Wl + r + 1), hy = (float)(Hl + r + 1);
  win.mx = (x > lo && x < hx) ? 1.f : ((x == lo || x == hx) ? 0.5f : 0.f);
  win.my = (y > lo && y < hy) ? 1.f : ((y == lo || y == hy) ? 0.5f : 0.f);
  const float cx = fminf(fmaxf(x, lo), hx);
  const float cy = fminf(fmaxf(y, lo), hy);
  const float tx = __fsub_rn(cx, (float)r), ty = __fsub_rn(cy, (float)r);
  const float fx0 = floorf(tx), fy0 = floorf(ty);
  win.x0 = (int)fx0;
  win.y0 = (int)fy0;
  win.fx = __fsub_rn(tx, fx0);
  win.fy = __fsub_rn(ty, fy0);
  win.gx = __fsub_rn(1.f, win.fx);
  win.gy = __fsub_rn(1.f, win.fy);
  return win;
}

// The aligned 4-byte word j of the patch row at level row y of a query
// whose level starts at `base`: its address, and in t0 the patch column of
// its element 0 (E j - phase, phase the offset of the row's column x0
// within its word; -1 .. S).
template <typename T>
__device__ __forceinline__ uintptr_t row_word(const void* base, int y, int x0, int Wl, int j,
                                              int& t0) {
  constexpr int E = Word<T>::E;
  const intptr_t a0 = reinterpret_cast<intptr_t>(base) +
                      ((int64_t)y * Wl + x0) * (int64_t)sizeof(T);
  t0 = E * j - (int)((a0 & 3) / (intptr_t)sizeof(T));
  return (uintptr_t)((a0 & ~(intptr_t)3) + 4 * j);
}

// Word j of patch row s of an accumulator laid out as the level: whether
// the thread of row s updates it, its address, and for each of its
// elements the patch slot s' S + t' it takes (-1: not a patch element on
// the level). Row s's thread takes the words that hold a patch element of
// row s, except a word whose element 0 is the previous row's last element
// and a patch element of that row (row s-1's thread takes it, and adds
// both). No division: a word's other element is at most one element before
// or after row s's. Needs every query's rows to start 4-byte aligned
// (`word_mode`).
template <int R, typename T>
__device__ __forceinline__ bool owned_word(const void* base, int Hl, int Wl, const Window& win,
                                           int s, int j, uintptr_t& addr,
                                           int (&slot)[Word<T>::E]) {
  constexpr int S = 2 * R + 2, E = Word<T>::E;
  const int yy = win.y0 + s, x0 = win.x0;
  int t0;
  addr = row_word<T>(base, yy, x0, Wl, j, t0);
  bool own = false;
#pragma unroll
  for (int h = 0; h < E; ++h) {
    const int t = t0 + h, c = x0 + t;
    slot[h] = (yy >= 0 && yy < Hl && t >= 0 && t < S && c >= 0 && c < Wl) ? s * S + t : -1;
    own |= slot[h] >= 0;
  }
  if (E == 2 && own) {
    // element 0 one before row s's start: (yy - 1, Wl - 1); element 1 one
    // past its end: (yy + 1, 0)
    const bool last_in = Wl - 1 >= x0 && Wl - 1 < x0 + S, first_in = x0 <= 0 && 0 < x0 + S;
    if (slot[0] < 0 && x0 + t0 == -1 && s >= 1 && yy >= 1 && last_in) return false;
    if (slot[E - 1] < 0 && x0 + t0 + 1 == Wl && s + 1 < S && yy + 1 < Hl && first_in)
      slot[E - 1] = (s + 1) * S - x0;
  }
  return own;
}

// Whether a level's accumulator can be updated in 4-byte words: every
// query's rows start on a word (no word holds two queries' elements).
template <typename T>
__device__ __forceinline__ bool word_mode(const void* grad, int Hl, int Wl) {
  return ((int64_t)Hl * Wl) % Word<T>::E == 0 && (reinterpret_cast<uintptr_t>(grad) & 3) == 0;
}

// The S taps of the patch row at level row yy of a query whose level starts
// at `base` (window corner x0), as float32, zero off the level: the row's
// aligned words are read (all issued by `load` before `unpack` uses
// any), element E j - phase of word j at column 0.
template <int R, typename T>
struct PatchRow {
  static constexpr int S = 2 * R + 2, E = Word<T>::E, NW = E == 1 ? S : S / 2 + 1;
  unsigned w[NW];
  int phase;

  __device__ __forceinline__ void load(const void* base, int Hl, int Wl, int yy, int x0) {
    int t0;
    const uintptr_t a = row_word<T>(base, yy, x0, Wl, 0, t0);
    phase = -t0;
    const bool row = yy >= 0 && yy < Hl;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      bool any = false;
#pragma unroll
      for (int h = 0; h < E; ++h) {
        const int t = E * j - phase + h;
        any |= t >= 0 && t < S && x0 + t >= 0 && x0 + t < Wl;
      }
      w[j] = (row && any) ? __ldg(reinterpret_cast<const unsigned*>(a) + j) : 0u;
    }
  }

  __device__ __forceinline__ void unpack(float (&v)[S], int Wl, int x0) const {
    if constexpr (E == 1) {
#pragma unroll
      for (int t = 0; t < S; ++t) v[t] = __uint_as_float(w[t]);
    } else {
#pragma unroll
      for (int k = 0; k < S / 2; ++k) {
        const unsigned u = phase ? __funnelshift_r(w[k], w[k + 1], 16) : w[k];
        v[2 * k] = Word<T>::get(u, 0);
        v[2 * k + 1] = Word<T>::get(u, 1);
      }
    }
#pragma unroll
    for (int t = 0; t < S; ++t) v[t] = (x0 + t >= 0 && x0 + t < Wl) ? v[t] : 0.f;
  }
};

// R1's threads hold little (40 registers unbounded): asking for 2016
// threads an SM (32 registers) measured 5-10% faster at RAFT's shapes.
template <int R, typename Tin, typename Tout>
__global__ void __launch_bounds__(kR1Queries * kMaxLevels * (2 * R + 1),
                                  2016 / (kR1Queries * kMaxLevels * (2 * R + 1)))
    raft_lookup_kernel(const __grid_constant__ Levels lv, const float* __restrict__ coords,
                       Tout* __restrict__ out, int Q) {
  constexpr int QPB = kR1Queries, S = 2 * R + 2, D = 2 * R + 1, K = D * D;
  constexpr int TQ = kMaxLevels * D, NB = QPB * TQ;   // threads a query, a block
  __shared__ __align__(16) Tout stage[QPB * kMaxLevels * K];
  const int tid = threadIdx.x, qi = tid / TQ, l = (tid - qi * TQ) / D;
  const int dy = tid - qi * TQ - l * D;
  const int q0 = blockIdx.x * QPB, nq = min(QPB, Q - q0), L = lv.n;

  if (qi < nq && l < L) {
    const int64_t q = q0 + qi;
    const int Hl = lv.h[l], Wl = lv.w[l];
    const Window win = make_window(__ldg(coords + 2 * q), __ldg(coords + 2 * q + 1),
                                   1.f / (float)(1 << l), Hl, Wl, R);
    const void* base = static_cast<const Tin*>(lv.ptr[l]) + q * Hl * Wl;
    PatchRow<R, Tin> top, bottom;   // patch rows dy and dy + 1
    top.load(base, Hl, Wl, win.y0 + dy, win.x0);
    bottom.load(base, Hl, Wl, win.y0 + dy + 1, win.x0);
    float a[S], b[S];
    top.unpack(a, Wl, win.x0);
    bottom.unpack(b, Wl, win.x0);
    const float w00 = __fmul_rn(win.gy, win.gx), w01 = __fmul_rn(win.gy, win.fx);
    const float w10 = __fmul_rn(win.fy, win.gx), w11 = __fmul_rn(win.fy, win.fx);
    Tout* o = stage + (qi * L + l) * K + dy;
#pragma unroll
    for (int dx = 0; dx < D; ++dx) {
      const float top2 = __fadd_rn(__fmul_rn(w00, a[dx]), __fmul_rn(w01, a[dx + 1]));
      const float v = __fadd_rn(__fadd_rn(top2, __fmul_rn(w10, b[dx])), __fmul_rn(w11, b[dx + 1]));
      o[dx * D] = from_float<Tout>(v);
    }
  }
  __syncthreads();

  // the block's span of out, in 16-byte units where it is aligned
  constexpr int V = 16 / sizeof(Tout);
  const int n = nq * L * K;
  Tout* dst = out + (int64_t)q0 * L * K;
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int units = n / V;
    for (int u = tid; u < units; u += NB)
      reinterpret_cast<uint4*>(dst)[u] = reinterpret_cast<const uint4*>(stage)[u];
    e0 = units * V;
  }
  for (int e = e0 + tid; e < n; e += NB) dst[e] = stage[e];
}

template <int R, typename Tlv, typename Tg>
__global__ void __launch_bounds__(kR2Queries * kMaxLevels * (2 * R + 2))
    raft_lookup_backward_kernel(const __grid_constant__ Levels lv,
                                const float* __restrict__ coords, const Tg* __restrict__ dout,
                                float* __restrict__ dcoords, int Q) {
  constexpr int QPB = kR2Queries, S = 2 * R + 2, D = 2 * R + 1, K = D * D;
  constexpr int TQ = kMaxLevels * S;                   // threads a query
  constexpr int E = Word<Tlv>::E, NW = PatchRow<R, Tlv>::NW;
  __shared__ Tlv dps[QPB][kMaxLevels][S * S];      // d p in the levels' dtype
  __shared__ float part[QPB][kMaxLevels][D][4];     // a window row's weight gradients
  __shared__ float2 dxy[QPB][kMaxLevels];           // a level's share of d coords
  const int tid = threadIdx.x, qi = tid / TQ, l = (tid - qi * TQ) / S;
  const int s = tid - qi * TQ - l * S;
  const int q0 = blockIdx.x * QPB, nq = min(QPB, Q - q0), L = lv.n;
  const bool live = qi < nq && l < L;
  const int64_t q = q0 + qi;
  const int Hl = live ? lv.h[l] : 1, Wl = live ? lv.w[l] : 1;
  const float scale = 1.f / (float)(1 << l);
  const Window win = make_window(live ? __ldg(coords + 2 * q) : 0.f,
                                 live ? __ldg(coords + 2 * q + 1) : 0.f, scale, Hl, Wl, R);
  Tlv* gbase = live ? static_cast<Tlv*>(lv.grad[l]) + q * Hl * Wl : nullptr;
  const bool words = live && word_mode<Tlv>(lv.grad[l], Hl, Wl);
  unsigned acc[NW];
  int owned[NW];   // 0, or 1 | (slot 0 + 1) << 1 | (slot 1 + 1) << 9 of an owned word
  if (live) {
    // in flight together: dout's window rows dy = s - 1 and s (g[dx D +
    // dy]; a level's threads read consecutive elements), this thread's
    // patch rows and the accumulator words it will update
    const Tg* g = dout + (q * L + l) * K;
    Tg g0[D], g1[D];
#pragma unroll
    for (int dx = 0; dx < D; ++dx) {
      g0[dx] = s >= 1 ? g[dx * D + s - 1] : from_float<Tg>(0.f);
      g1[dx] = s < D ? g[dx * D + s] : from_float<Tg>(0.f);
    }
    const void* base = static_cast<const Tlv*>(lv.ptr[l]) + q * Hl * Wl;
    PatchRow<R, Tlv> top, bottom;   // patch rows s and s + 1
    top.load(base, Hl, Wl, win.y0 + s, win.x0);
    bottom.load(base, Hl, Wl, s < D ? win.y0 + s + 1 : -1, win.x0);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uintptr_t a;
      int slot[E];
      owned[j] = 0;
      acc[j] = 0u;
      if (words && owned_word<R, Tlv>(gbase, Hl, Wl, win, s, j, a, slot)) {
        acc[j] = *reinterpret_cast<const unsigned*>(a);
        owned[j] = 1 | ((slot[0] + 1) << 1) | ((slot[E - 1] + 1) << 9);
      }
    }

    if (s < D) {   // window row dy = s: its share of S_kl = sum g p_kl
      float a[S], b[S];
      top.unpack(a, Wl, win.x0);
      bottom.unpack(b, Wl, win.x0);
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll
      for (int dx = 0; dx < D; ++dx) {
        const float gc = to_float(g1[dx]);
        s00 += gc * a[dx];
        s01 += gc * a[dx + 1];
        s10 += gc * b[dx];
        s11 += gc * b[dx + 1];
      }
      part[qi][l][s][0] = s00;
      part[qi][l][s][1] = s01;
      part[qi][l][s][2] = s10;
      part[qi][l][s][3] = s11;
    }
    // d p of patch row s
    const float w00 = __fmul_rn(win.gy, win.gx), w01 = __fmul_rn(win.gy, win.fx);
    const float w10 = __fmul_rn(win.fy, win.gx), w11 = __fmul_rn(win.fy, win.fx);
#pragma unroll
    for (int t = 0; t < S; ++t) {
      float v = 0.f;
      if (s >= 1 && t >= 1) v = __fadd_rn(v, __fmul_rn(w11, to_float(g0[t - 1])));
      if (s >= 1 && t < D) v = __fadd_rn(v, __fmul_rn(w10, to_float(g0[t])));
      if (s < D && t >= 1) v = __fadd_rn(v, __fmul_rn(w01, to_float(g1[t - 1])));
      if (s < D && t < D) v = __fadd_rn(v, __fmul_rn(w00, to_float(g1[t])));
      dps[qi][l][s * S + t] = from_float<Tlv>(v);
    }
  }
  __syncthreads();

  if (live && s == 0) {   // the level's share of d coords, window rows in order
    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
    for (int r = 0; r < D; ++r) {
      s00 += part[qi][l][r][0];
      s01 += part[qi][l][r][1];
      s10 += part[qi][l][r][2];
      s11 += part[qi][l][r][3];
    }
    // w00 = gy gx, w01 = gy fx, w10 = fy gx, w11 = fy fx
    const float dfx = s01 * win.gy + s11 * win.fy, dgx = s00 * win.gy + s10 * win.fy;
    const float dfy = s10 * win.gx + s11 * win.fx, dgy = s00 * win.gx + s01 * win.fx;
    dxy[qi][l] = make_float2((dfx - dgx) * win.mx * scale, (dfy - dgy) * win.my * scale);
  }
  if (live) {
    const Tlv* dp = dps[qi][l];
    if (words) {
      int t0;
      const uintptr_t a0 = row_word<Tlv>(gbase, win.y0 + s, win.x0, Wl, 0, t0);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        if (!owned[j]) continue;
        unsigned w = acc[j];
#pragma unroll
        for (int h = 0; h < E; ++h) {
          const int slot = ((owned[j] >> (1 + 8 * h)) & 255) - 1;
          if (slot >= 0)
            w = Word<Tlv>::set(w, h, __fadd_rn(Word<Tlv>::get(w, h), to_float(dp[slot])));
        }
        reinterpret_cast<unsigned*>(a0)[j] = w;
      }
    } else {   // element by element: no word is shared with another query
      const int yy = win.y0 + s;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int xx = win.x0 + t;
        if (yy < 0 || yy >= Hl || xx < 0 || xx >= Wl) continue;
        Tlv* e = gbase + (int64_t)yy * Wl + xx;
        *e = from_float<Tlv>(__fadd_rn(to_float(*e), to_float(dp[s * S + t])));
      }
    }
  }
  __syncthreads();
  if (qi < nq && l == 0 && s == 0) {   // the query's d coords, levels in order
    float gx = 0.f, gy = 0.f;
    for (int m = 0; m < L; ++m) {
      gx += dxy[qi][m].x;
      gy += dxy[qi][m].y;
    }
    dcoords[2 * q] = gx;
    dcoords[2 * q + 1] = gy;
  }
}

bool fill_levels(Levels& lv, const void* const* levels, void* const* grads, const int* heights,
                 const int* widths, int n) {
  if (n < 1 || n > kMaxLevels) return false;
  lv.n = n;
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = i < n ? levels[i] : nullptr;
    lv.grad[i] = (i < n && grads) ? grads[i] : nullptr;
    lv.h[i] = i < n ? heights[i] : 1;
    lv.w[i] = i < n ? widths[i] : 1;
    if (i < n && (lv.h[i] < 1 || lv.w[i] < 1)) return false;
  }
  return true;
}

template <int R>
int launch_forward(const Levels& lv, const float* coords, void* out, int Q, int in_bf16,
                   int out_bf16, cudaStream_t s) {
  constexpr int QPB = kR1Queries;
  const dim3 grid((unsigned)((Q + QPB - 1) / QPB)), block(QPB * kMaxLevels * (2 * R + 1));
  if (in_bf16 && out_bf16)
    raft_lookup_kernel<R, bf16, bf16><<<grid, block, 0, s>>>(lv, coords, (bf16*)out, Q);
  else if (in_bf16)
    raft_lookup_kernel<R, bf16, float><<<grid, block, 0, s>>>(lv, coords, (float*)out, Q);
  else if (out_bf16)
    raft_lookup_kernel<R, float, bf16><<<grid, block, 0, s>>>(lv, coords, (bf16*)out, Q);
  else
    raft_lookup_kernel<R, float, float><<<grid, block, 0, s>>>(lv, coords, (float*)out, Q);
  return (int)cudaGetLastError();
}

template <int R>
int launch_backward(const Levels& lv, const float* coords, const void* dout, float* dcoords,
                    int Q, int lv_bf16, int g_bf16, cudaStream_t s) {
  constexpr int QPB = kR2Queries;
  const dim3 grid((unsigned)((Q + QPB - 1) / QPB)), block(QPB * kMaxLevels * (2 * R + 2));
  if (lv_bf16 && g_bf16)
    raft_lookup_backward_kernel<R, bf16, bf16>
        <<<grid, block, 0, s>>>(lv, coords, (const bf16*)dout, dcoords, Q);
  else if (lv_bf16)
    raft_lookup_backward_kernel<R, bf16, float>
        <<<grid, block, 0, s>>>(lv, coords, (const float*)dout, dcoords, Q);
  else if (g_bf16)
    raft_lookup_backward_kernel<R, float, bf16>
        <<<grid, block, 0, s>>>(lv, coords, (const bf16*)dout, dcoords, Q);
  else
    raft_lookup_backward_kernel<R, float, float>
        <<<grid, block, 0, s>>>(lv, coords, (const float*)dout, dcoords, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// levels[n] (Q, heights[i], widths[i]) of one dtype (in_bf16: bfloat16, else
// float32), coords (Q, 2) float32 -> out (Q, n (2 radius + 1)^2) (out_bf16:
// bfloat16, else float32). Returns a cudaError_t.
extern "C" int dsfm_raft_lookup(const void* const* levels, const int* heights, const int* widths,
                                int n_levels, const void* coords, void* out, long long Q,
                                int radius, int in_bf16, int out_bf16, void* stream) {
  Levels lv;
  if (Q < 1 || Q > 0x7fffffffLL || !fill_levels(lv, levels, nullptr, heights, widths, n_levels))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  const int q = (int)Q;
  switch (radius) {
    case 1: return launch_forward<1>(lv, c, out, q, in_bf16, out_bf16, s);
    case 2: return launch_forward<2>(lv, c, out, q, in_bf16, out_bf16, s);
    case 3: return launch_forward<3>(lv, c, out, q, in_bf16, out_bf16, s);
    case 4: return launch_forward<4>(lv, c, out, q, in_bf16, out_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As dsfm_raft_lookup, with dout (Q, n (2 radius + 1)^2) (g_bf16: bfloat16,
// else float32): adds the patch gradients into grads[n] (Q, heights[i],
// widths[i]) in the levels' dtype and writes dcoords (Q, 2) float32.
extern "C" int dsfm_raft_lookup_backward(const void* const* levels, void* const* grads,
                                         const int* heights, const int* widths, int n_levels,
                                         const void* coords, const void* dout, void* dcoords,
                                         long long Q, int radius, int lv_bf16, int g_bf16,
                                         void* stream) {
  Levels lv;
  if (Q < 1 || Q > 0x7fffffffLL || grads == nullptr ||
      !fill_levels(lv, levels, grads, heights, widths, n_levels))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  float* dc = static_cast<float*>(dcoords);
  const int q = (int)Q;
  switch (radius) {
    case 1: return launch_backward<1>(lv, c, dout, dc, q, lv_bf16, g_bf16, s);
    case 2: return launch_backward<2>(lv, c, dout, dc, q, lv_bf16, g_bf16, s);
    case 3: return launch_backward<3>(lv, c, dout, dc, q, lv_bf16, g_bf16, s);
    case 4: return launch_backward<4>(lv, c, dout, dc, q, lv_bf16, g_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
