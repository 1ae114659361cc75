// The plane sweep's sampling rule and its backward's tap box, shared by B1's
// sweep kernels (sweep_warp.cu: the volume, its backward, its pose gradient)
// and by REGNet's sweep correlation and its backward (sweep_corr.cu), so every
// one of them samples each (pixel, plane, pose) at the very taps, with the
// very weights, of ops/camera.py::sweep_pixel_coords and
// bilinear_sample_plain, and both backwards bound their taps by the rule of
// ops/camera.py::sweep_tap_box_plain.

#pragma once

#include "bilinear.cuh"

namespace {

// The sweep's sample of ref pixel (x, y) of batch item b: the ray
// M [u, v, 1] once per pixel, then per plane depth d the point
// p = ray d + K t and the perspective divide, rounded op by op in the plain
// version's order (ops/camera.py::sweep_pixel_coords). Every sweep kernel takes
// its taps from here, so a backward scatters to the very taps, with the very
// weights, that its forward read. `b` indexes M (9 floats) and Kt (3).
struct SweepRay {
  float ray[3], kt[3];
  __device__ __forceinline__ SweepRay(const float* M, const float* Kt, int b, int x, int y) {
    const float u = (float)x, v = (float)y;
    const float* m = M + 9 * b;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float mu = __fmul_rn(__ldg(m + 3 * i), u), mv = __fmul_rn(__ldg(m + 3 * i + 1), v);
      ray[i] = __fadd_rn(__fadd_rn(mu, mv), __ldg(m + 3 * i + 2));
      kt[i] = __ldg(Kt + 3 * b + i);
    }
  }
  // the point p = ray d + K t of plane depth d
  __device__ __forceinline__ void point(float dep, float* p) const {
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = __fadd_rn(__fmul_rn(ray[i], dep), kt[i]);
  }
  __device__ __forceinline__ Taps taps(float dep, int H, int W) const {
    float p[3];
    point(dep, p);
    // z <= 1e-3: behind the camera; the sample goes to (2W, 2H), i.e. zero
    const bool behind = p[2] <= 1e-3f;
    const float z = fmaxf(p[2], 1e-3f);
    const float xs = behind ? (float)(2 * W) : __fdiv_rn(p[0], z);
    const float ys = behind ? (float)(2 * H) : __fdiv_rn(p[1], z);
    return Taps(xs, ys, H, W);
  }
};

// The box of one tile group, as the block's first warp computes it and
// ops/camera.py::sweep_tap_box_plain repeats: lanes 0..7 take the tile's
// four corner pixels at the group's least and greatest plane depth (their
// rays with SweepRay's rounding); if every point lies in front of the
// z = 1e-3 plane, z > 1e-3 over the whole tile and depth range (z is affine
// in u, v and in d), the tile's image on a plane is the convex quad of its
// corner images and x, y are monotone in d, so every sample lies in the
// bounding box of the 8 points. The box is padded by one pixel on each side
// for rounding, by one more on the far side for the +1 taps, and clipped to
// the frame. `direct` marks a group whose points are not all in front, or
// whose box holds more than `cap` pixels.
struct GroupBox {
  int x0, y0, w, h, direct;
};

__device__ __forceinline__ GroupBox group_box(const float* __restrict__ depths,
                                              const float* __restrict__ M,
                                              const float* __restrict__ Kt, int b, int d0,
                                              int d1, int tx0, int ty0, int tx1, int ty1,
                                              int H, int W, int cap, int lane) {
  const float inf = __int_as_float(0x7f800000);
  float xlo = inf, xhi = -inf, ylo = inf, yhi = -inf;
  int behind = 0;
  if (lane < 8) {
    float dmin = __ldg(depths + d0), dmax = dmin;
    for (int d = d0 + 1; d < d1; ++d) {
      const float dep = __ldg(depths + d);
      dmin = fminf(dmin, dep);
      dmax = fmaxf(dmax, dep);
    }
    const SweepRay corner(M, Kt, b, (lane & 1) ? tx1 : tx0, (lane & 2) ? ty1 : ty0);
    float p[3];
    corner.point((lane & 4) ? dmax : dmin, p);
    if (p[2] <= 1e-3f) {
      behind = 1;
    } else {
      xlo = xhi = __fdiv_rn(p[0], p[2]);
      ylo = yhi = __fdiv_rn(p[1], p[2]);
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, off));
    xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, off));
    ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, off));
    yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, off));
    behind |= __shfl_xor_sync(0xffffffffu, behind, off);
  }
  GroupBox g;
  // clamped first, so a point far off the frame cannot overflow the ints
  const float fw = (float)W, fh = (float)H;
  g.x0 = max((int)floorf(fminf(fmaxf(xlo, -4.f), fw + 4.f)) - 1, 0);
  g.y0 = max((int)floorf(fminf(fmaxf(ylo, -4.f), fh + 4.f)) - 1, 0);
  const int x1 = min((int)floorf(fminf(fmaxf(xhi, -4.f), fw + 4.f)) + 2, W - 1);
  const int y1 = min((int)floorf(fminf(fmaxf(yhi, -4.f), fh + 4.f)) + 2, H - 1);
  g.w = max(x1 - g.x0 + 1, 0);
  g.h = max(y1 - g.y0 + 1, 0);
  g.direct = behind || g.w * g.h > cap;
  if (g.direct) g.w = g.h = 0;
  return g;
}

// Channel c of box pixel q in the shared accumulator: rotated by q inside
// its 32-float window when C is a multiple of 32, so the lanes of a warp,
// whose pixels sample neighbouring taps, add into 32 different banks.
__device__ __forceinline__ int smem_slot(int q, int c, int C) {
  return q * C + ((C & 31) ? c : ((c & ~31) | ((c + q) & 31)));
}

// dst[0..kVec) += g * w, as kVec / 4 16-byte vector reductions (sm_90).
template <int kVec>
__device__ __forceinline__ void red16(float* dst, const float* g, float w) {
#pragma unroll
  for (int k = 0; k < kVec; k += 4)
    atomicAdd(reinterpret_cast<float4*>(dst + k),
              make_float4(__fmul_rn(g[k], w), __fmul_rn(g[k + 1], w),
                          __fmul_rn(g[k + 2], w), __fmul_rn(g[k + 3], w)));
}

}  // namespace
