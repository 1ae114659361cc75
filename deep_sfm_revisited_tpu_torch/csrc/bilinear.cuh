// B1's sampling rule, shared by kernel B1 (sweep_warp.cu) and by B2's
// warp-and-correlation entry point (local_corr.cu): the taps, weights and
// blend of one bilinear sample, align_corners=True, exactly zero where the
// pre-clip (x, y) lies outside [0, W-1] x [0, H-1]. Every operation is
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn forbid FMA
// contraction), in the order of the plain PyTorch version
// (ops/camera.py::bilinear_sample_plain), so both kernels give its bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11,
                                       float wx, float ax, float wy, float ay,
                                       float valid) {
  // ((v00 (1-wx) + v01 wx) (1-wy) + (v10 (1-wx) + v11 wx) wy) * valid,
  // rounded op by op exactly as the plain version's separate tensor ops
  float top = __fadd_rn(__fmul_rn(v00, ax), __fmul_rn(v01, wx));
  float bot = __fadd_rn(__fmul_rn(v10, ax), __fmul_rn(v11, wx));
  return __fmul_rn(__fadd_rn(__fmul_rn(top, ay), __fmul_rn(bot, wy)), valid);
}

// Taps and weights of one sample, by B1's rule: zero (valid = 0) where the
// pre-clip (x, y) lies outside the frame, the clamped +1 taps where their
// weight is 0. Offsets are in pixels from the image's origin.
struct Taps {
  int64_t i00, i01, i10, i11;
  int xi, yi, xi1, yi1;
  float wx, ax, wy, ay, valid;
  __device__ __forceinline__ Taps(float x, float y, int H, int W) {
    const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
    valid = (x >= 0.f && x <= wm1 && y >= 0.f && y <= hm1) ? 1.f : 0.f;
    x = fminf(fmaxf(x, 0.f), wm1);
    y = fminf(fmaxf(y, 0.f), hm1);
    const float x0 = floorf(x), y0 = floorf(y);
    wx = __fsub_rn(x, x0);
    wy = __fsub_rn(y, y0);
    ax = __fsub_rn(1.f, wx);
    ay = __fsub_rn(1.f, wy);
    xi = min(max((int)x0, 0), W - 1);
    yi = min(max((int)y0, 0), H - 1);
    xi1 = min(xi + 1, W - 1);
    yi1 = min(yi + 1, H - 1);
    i00 = (int64_t)yi * W + xi;
    i01 = (int64_t)yi * W + xi1;
    i10 = (int64_t)yi1 * W + xi;
    i11 = (int64_t)yi1 * W + xi1;
  }
};

}  // namespace
