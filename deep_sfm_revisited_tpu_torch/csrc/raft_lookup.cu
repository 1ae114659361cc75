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
// R2 (dsfm_raft_lookup_backward) takes dout of that shape and writes the
// gradient of every level, (Q, Hl, Wl) in the levels' dtype, densely (each
// element once, zero where no window tap lands), and of the coordinates,
// (Q, 2) float32:
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
// rows of 20 bytes); R2 at a b = 4, 256x768 training step (Q = 12288,
// 4080 values a query) writes the dense gradient of the pyramid, 100 MB in
// bfloat16, and reads dout (7.96 MB) and the patches. The arithmetic is a
// few hundred operations a (query, level).
//
// Design (simple and right first):
//   * Mapping. One block a query, one warp a level (blockDim (32, L)). A
//     warp stages its (2r+2)^2 patch into shared memory as float32, with
//     taps off the level as 0 (no padded copy of the pyramid exists), then
//     each lane blends channels lane, lane+32, lane+64 of the level's
//     (2r+1)^2 and stores them: the level's run of channels is contiguous.
//   * Rounding. Every float32 operation is rounded on its own (__fmul_rn,
//     __fadd_rn, __fsub_rn forbid FMA contraction) in the order of the
//     plain PyTorch version (models/raft.py::lookup_correlation_plain), so
//     R1 gives its bits, and R2 gives its bits for the levels' gradient.
//     The coordinates' gradient sums 81 products a weight in a fixed lane
//     order and a warp tree (deterministic, not the plain version's order).
//   * R2's dense write. After the warps have left each level's patch
//     gradient in shared memory, the whole block writes the query's row of
//     every level in 16-byte units (8 bfloat16 or 4 float32 elements; a
//     scalar loop where a row is not a multiple of 16 bytes), so each
//     gradient element is written once, with no fill before it and no
//     atomics: a query owns its rows. A unit outside the patch's rows is
//     stored as zeros without locating its elements.
//   * Parameters. The level table is a `__grid_constant__` kernel
//     parameter, read in place at a warp's level: taken by value, its
//     runtime-indexed arrays cost every thread a 104-byte copy to local
//     memory (a 104-byte stack frame in nvcc's report).
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
constexpr int kMaxRadius = 4;

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

// The window of one (query, level): clip, corner and weights, as the plain
// version computes them in float32.
struct Window {
  int x0, y0;
  float fx, fy, gx, gy;   // gx = 1 - fx, gy = 1 - fy
  float mx, my;           // clip' of x and y: 1, 0.5 or 0
  __device__ __forceinline__ Window(float x, float y, float scale, int Hl, int Wl, int r) {
    x = __fmul_rn(x, scale);
    y = __fmul_rn(y, scale);
    const float lo = -(float)(r + 2);
    const float hx = (float)(Wl + r + 1), hy = (float)(Hl + r + 1);
    mx = (x > lo && x < hx) ? 1.f : ((x == lo || x == hx) ? 0.5f : 0.f);
    my = (y > lo && y < hy) ? 1.f : ((y == lo || y == hy) ? 0.5f : 0.f);
    const float cx = fminf(fmaxf(x, lo), hx);
    const float cy = fminf(fmaxf(y, lo), hy);
    const float tx = __fsub_rn(cx, (float)r), ty = __fsub_rn(cy, (float)r);
    const float fx0 = floorf(tx), fy0 = floorf(ty);
    x0 = (int)fx0;
    y0 = (int)fy0;
    fx = __fsub_rn(tx, fx0);
    fy = __fsub_rn(ty, fy0);
    gx = __fsub_rn(1.f, fx);
    gy = __fsub_rn(1.f, fy);
  }
};

// Stage the (2r+2)^2 patch of one (query, level) as float32, zero off the
// level; lanes take taps lane, lane+32, ...
template <int R, typename T>
__device__ __forceinline__ void stage_patch(float* patch, const T* row, const Window& win,
                                            int Hl, int Wl, int lane) {
  constexpr int S = 2 * R + 2;
  for (int k = lane; k < S * S; k += 32) {
    const int s = k / S, t = k - s * S;
    const int y = win.y0 + s, x = win.x0 + t;
    patch[k] = (y >= 0 && y < Hl && x >= 0 && x < Wl) ? to_float(row[(int64_t)y * Wl + x]) : 0.f;
  }
}

template <int R, typename Tin, typename Tout>
__global__ void __launch_bounds__(32 * kMaxLevels)
    raft_lookup_kernel(const __grid_constant__ Levels lv, const float* __restrict__ coords,
                       Tout* __restrict__ out) {
  constexpr int S = 2 * R + 2, D = 2 * R + 1, K = D * D;
  __shared__ float patches[kMaxLevels][S * S];
  const int lane = threadIdx.x, l = threadIdx.y;
  const int64_t q = blockIdx.x;
  const int Hl = lv.h[l], Wl = lv.w[l];
  const Window win(coords[2 * q], coords[2 * q + 1], 1.f / (float)(1 << l), Hl, Wl, R);
  float* patch = patches[l];
  stage_patch<R>(patch, static_cast<const Tin*>(lv.ptr[l]) + q * Hl * Wl, win, Hl, Wl, lane);
  __syncwarp();
  const float w00 = __fmul_rn(win.gy, win.gx), w01 = __fmul_rn(win.gy, win.fx);
  const float w10 = __fmul_rn(win.fy, win.gx), w11 = __fmul_rn(win.fy, win.fx);
  Tout* o = out + q * (int64_t)(lv.n * K) + l * K;
  for (int c = lane; c < K; c += 32) {
    const int dx = c / D, dy = c - dx * D;
    const float* p = patch + dy * S + dx;
    const float v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w00, p[0]), __fmul_rn(w01, p[1])),
                                        __fmul_rn(w10, p[S])),
                              __fmul_rn(w11, p[S + 1]));
    o[c] = from_float<Tout>(v);
  }
}

// One element of a level's dense gradient row: the patch gradient where the
// element lies under the patch, else 0.
template <int R>
__device__ __forceinline__ float grad_at(const float* dpatch, int y, int x, int y0, int x0) {
  constexpr int S = 2 * R + 2;
  const int s = y - y0, t = x - x0;
  return (s >= 0 && s < S && t >= 0 && t < S) ? dpatch[s * S + t] : 0.f;
}

template <int R, typename T>
__device__ void write_grad_row(T* row, const float* dpatch, int Hl, int Wl, int y0, int x0,
                               int tid, int nthreads) {
  constexpr int S = 2 * R + 2, V = 16 / sizeof(T);
  const int n = Hl * Wl;
  // the elements [lo, hi) hold the patch's rows; all others are 0
  const int lo = max(y0, 0) * Wl, hi = min(y0 + S, Hl) * Wl;
  if (n % V == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    for (int u = tid; u < n / V; u += nthreads) {
      const int e0 = u * V;
      if (e0 + V <= lo || e0 >= hi) {
        reinterpret_cast<uint4*>(row)[u] = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      int y = e0 / Wl, x = e0 - y * Wl;
      union {
        uint4 vec;
        T val[V];
      } pack;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        pack.val[j] = from_float<T>(grad_at<R>(dpatch, y, x, y0, x0));
        if (++x == Wl) {
          x = 0;
          ++y;
        }
      }
      reinterpret_cast<uint4*>(row)[u] = pack.vec;
    }
  } else {
    for (int e = tid; e < n; e += nthreads) {
      if (e < lo || e >= hi) {
        row[e] = from_float<T>(0.f);
        continue;
      }
      const int y = e / Wl, x = e - y * Wl;
      row[e] = from_float<T>(grad_at<R>(dpatch, y, x, y0, x0));
    }
  }
}

template <int R, typename Tlv, typename Tg>
__global__ void __launch_bounds__(32 * kMaxLevels)
    raft_lookup_backward_kernel(const __grid_constant__ Levels lv,
                                const float* __restrict__ coords, const Tg* __restrict__ dout,
                                float* __restrict__ dcoords) {
  constexpr int S = 2 * R + 2, D = 2 * R + 1, K = D * D;
  __shared__ float patches[kMaxLevels][S * S];   // taps, then the patch gradient
  __shared__ float gwin[kMaxLevels][K];
  __shared__ float dxy[kMaxLevels][2];
  __shared__ int corner[kMaxLevels][2];
  const int lane = threadIdx.x, l = threadIdx.y;
  const int64_t q = blockIdx.x;
  const int Hl = lv.h[l], Wl = lv.w[l];
  const float scale = 1.f / (float)(1 << l);
  const Window win(coords[2 * q], coords[2 * q + 1], scale, Hl, Wl, R);
  float* patch = patches[l];
  float* g = gwin[l];
  stage_patch<R>(patch, static_cast<const Tlv*>(lv.ptr[l]) + q * Hl * Wl, win, Hl, Wl, lane);
  const Tg* gq = dout + q * (int64_t)(lv.n * K) + l * K;
  for (int c = lane; c < K; c += 32) g[c] = to_float(gq[c]);
  __syncwarp();

  // the weights' gradients: S_kl = sum over the window of g * p_kl
  float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
  for (int c = lane; c < K; c += 32) {
    const int dx = c / D, dy = c - dx * D;
    const float* p = patch + dy * S + dx;
    const float gc = g[c];
    s00 += gc * p[0];
    s01 += gc * p[1];
    s10 += gc * p[S];
    s11 += gc * p[S + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s00 += __shfl_xor_sync(0xffffffffu, s00, off);
    s01 += __shfl_xor_sync(0xffffffffu, s01, off);
    s10 += __shfl_xor_sync(0xffffffffu, s10, off);
    s11 += __shfl_xor_sync(0xffffffffu, s11, off);
  }
  if (lane == 0) {
    // w00 = gy gx, w01 = gy fx, w10 = fy gx, w11 = fy fx
    const float dfx = s01 * win.gy + s11 * win.fy, dgx = s00 * win.gy + s10 * win.fy;
    const float dfy = s10 * win.gx + s11 * win.fx, dgy = s00 * win.gx + s01 * win.fx;
    dxy[l][0] = (dfx - dgx) * win.mx * scale;
    dxy[l][1] = (dfy - dgy) * win.my * scale;
    corner[l][0] = win.y0;
    corner[l][1] = win.x0;
  }
  __syncwarp();   // every lane has read the taps: the patch becomes its gradient

  const float w00 = __fmul_rn(win.gy, win.gx), w01 = __fmul_rn(win.gy, win.fx);
  const float w10 = __fmul_rn(win.fy, win.gx), w11 = __fmul_rn(win.fy, win.fx);
  for (int k = lane; k < S * S; k += 32) {
    const int s = k / S, t = k - s * S;
    float acc = 0.f;
    if (s >= 1 && t >= 1) acc = __fadd_rn(acc, __fmul_rn(w11, g[(t - 1) * D + s - 1]));
    if (s >= 1 && t < D) acc = __fadd_rn(acc, __fmul_rn(w10, g[t * D + s - 1]));
    if (s < D && t >= 1) acc = __fadd_rn(acc, __fmul_rn(w01, g[(t - 1) * D + s]));
    if (s < D && t < D) acc = __fadd_rn(acc, __fmul_rn(w00, g[t * D + s]));
    patch[k] = acc;
  }
  __syncthreads();

  const int tid = l * 32 + lane, nthreads = 32 * lv.n;
  for (int m = 0; m < lv.n; ++m) {
    Tlv* row = static_cast<Tlv*>(lv.grad[m]) + q * lv.h[m] * lv.w[m];
    write_grad_row<R>(row, patches[m], lv.h[m], lv.w[m], corner[m][0], corner[m][1], tid,
                      nthreads);
  }
  if (tid == 0) {
    float gx = 0.f, gy = 0.f;
    for (int m = 0; m < lv.n; ++m) {
      gx += dxy[m][0];
      gy += dxy[m][1];
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
int launch_forward(const Levels& lv, const float* coords, void* out, int64_t Q, int in_bf16,
                   int out_bf16, cudaStream_t s) {
  const dim3 grid((unsigned)Q), block(32, lv.n);
  if (in_bf16 && out_bf16)
    raft_lookup_kernel<R, bf16, bf16><<<grid, block, 0, s>>>(lv, coords, (bf16*)out);
  else if (in_bf16)
    raft_lookup_kernel<R, bf16, float><<<grid, block, 0, s>>>(lv, coords, (float*)out);
  else if (out_bf16)
    raft_lookup_kernel<R, float, bf16><<<grid, block, 0, s>>>(lv, coords, (bf16*)out);
  else
    raft_lookup_kernel<R, float, float><<<grid, block, 0, s>>>(lv, coords, (float*)out);
  return (int)cudaGetLastError();
}

template <int R>
int launch_backward(const Levels& lv, const float* coords, const void* dout, float* dcoords,
                    int64_t Q, int lv_bf16, int g_bf16, cudaStream_t s) {
  const dim3 grid((unsigned)Q), block(32, lv.n);
  if (lv_bf16 && g_bf16)
    raft_lookup_backward_kernel<R, bf16, bf16>
        <<<grid, block, 0, s>>>(lv, coords, (const bf16*)dout, dcoords);
  else if (lv_bf16)
    raft_lookup_backward_kernel<R, bf16, float>
        <<<grid, block, 0, s>>>(lv, coords, (const float*)dout, dcoords);
  else if (g_bf16)
    raft_lookup_backward_kernel<R, float, bf16>
        <<<grid, block, 0, s>>>(lv, coords, (const bf16*)dout, dcoords);
  else
    raft_lookup_backward_kernel<R, float, float>
        <<<grid, block, 0, s>>>(lv, coords, (const float*)dout, dcoords);
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
  switch (radius) {
    case 1: return launch_forward<1>(lv, c, out, Q, in_bf16, out_bf16, s);
    case 2: return launch_forward<2>(lv, c, out, Q, in_bf16, out_bf16, s);
    case 3: return launch_forward<3>(lv, c, out, Q, in_bf16, out_bf16, s);
    case 4: return launch_forward<4>(lv, c, out, Q, in_bf16, out_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As dsfm_raft_lookup, with dout (Q, n (2 radius + 1)^2) (g_bf16: bfloat16,
// else float32) -> grads[n] (Q, heights[i], widths[i]) in the levels' dtype,
// every element written, and dcoords (Q, 2) float32.
extern "C" int dsfm_raft_lookup_backward(const void* const* levels, void* const* grads,
                                         const int* heights, const int* widths, int n_levels,
                                         const void* coords, const void* dout, void* dcoords,
                                         long long Q, int radius, int lv_bf16, int g_bf16,
                                         void* stream) {
  Levels lv;
  if (Q < 1 || Q > 0x7fffffffLL || !fill_levels(lv, levels, grads, heights, widths, n_levels))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  float* dc = static_cast<float*>(dcoords);
  switch (radius) {
    case 1: return launch_backward<1>(lv, c, dout, dc, Q, lv_bf16, g_bf16, s);
    case 2: return launch_backward<2>(lv, c, dout, dc, Q, lv_bf16, g_bf16, s);
    case 3: return launch_backward<3>(lv, c, dout, dc, Q, lv_bf16, g_bf16, s);
    case 4: return launch_backward<4>(lv, c, dout, dc, Q, lv_bf16, g_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
