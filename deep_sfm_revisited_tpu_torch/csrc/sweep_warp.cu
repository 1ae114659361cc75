// Kernel B1: bilinear gather for DICL's and PWC-DC's flow warps, and the
// fused plane-sweep cost volume of PSNet with its two gradients, written for
// Hopper (sm_90a).
//
// Replaces deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py::
// bilinear_sample_pallas (the Pallas TPU kernel; its semantics are
// ops/camera.py::bilinear_sample of the JAX package): sample an NHWC image
// at (x, y) pixel coordinates, align_corners=True, and give exactly zero
// where the PRE-clip (x, y) lies outside [0, W-1] x [0, H-1]. Taps,
// weights and the blend are float32; the result is stored in the image's
// dtype (float32 or bfloat16). The blend uses __fmul_rn/__fadd_rn, which
// forbid FMA contraction, so every result is bit-identical to the plain
// PyTorch versions of the port (ops/camera.py::bilinear_sample_plain and
// ops/camera.py::plane_sweep_volume_plain).
//
// Four entry points share that rule (`Taps`, `SweepRay` and `blend` below):
//
// dsfm_bilinear_sample -- the generic gather at given coordinates, used by
// the flow warps. One thread per (query, 16-byte channel chunk), so
// neighbouring threads read and write neighbouring 16-byte chunks and every
// store is a full, coalesced 16-byte vector. The warps are small (at most
// 96x320 queries) and launch-bound, so all three entry points are launched
// through PyTorch operators (sweep_warp_ops.cpp), not from Python.
//
// dsfm_plane_sweep_volume -- PSNet's whole cost volume in one pass, the
// JAX package's (B, D, H, W, 2C) layout with [ref | warped] on the last
// axis (deep_sfm_revisited_tpu/models/psnet.py:253-260), which is also
// cuDNN's NDHWC: the (B, 2C, D, H, W) view of it has channels-last-3d
// strides. The sampling coordinates are computed inline: per ref pixel
// (u, v) the ray M [u, v, 1] (M = K R K^-1) once, per plane depth d the
// point p = ray d + K t and the perspective divide, with the reference's
// rule that z <= 1e-3 sends the sample to (2W, 2H), i.e. to zero.
//
// What bounds it: device-memory bytes. At the PSNet shape (96x320, C = 32
// bf16, 128 planes) it reads two 1.97 MB feature maps and writes the 503 MB
// volume once: ~507 MB, 0.151 ms at the H100's 3.35 TB/s, at about one
// floating-point operation per output byte. So every choice serves the
// store stream:
// - a work item is a tile of pixels of one row and a chunk of planes; its
//   threads load the tile's ref features and compute its rays once, and the
//   ref half of every plane's output is a register copy;
// - thread k of a pixel owns channel chunk k (16 bytes) of both halves, so
//   each warp store covers whole 32-byte sectors and a row tile is one
//   contiguous stretch of the volume;
// - stores are streaming (st.global.cs, evict-first), so the 503 MB stream
//   does not push the 2 MB target map out of the 50 MB L2 and the four
//   taps of a sample stay cache hits (neighbouring pixels share taps in L1);
// - the grid is persistent, a few blocks per SM as the occupancy allows,
//   each walking work items in a stride, so one item's stores overlap
//   another's tap loads without a tail of tiny blocks.
// The coordinate arithmetic is rounded op by op in the plain version's
// order (__fmul_rn, __fadd_rn, __fdiv_rn), so the volume is bit-identical.
//
// dsfm_plane_sweep_volume_backward -- the volume's gradient with respect to
// the two feature maps, for training PSNet's feature extractor through the
// volume. It replaces the gradient XLA derives for the JAX package's cost
// volume (deep_sfm_revisited_tpu/models/psnet.py:253-260: the broadcast
// ref half and the gather of plane_sweep_warp, concatenated). dref is the
// sum of dvol's ref half over the D planes; dtgt is dvol's warped half
// scattered back onto the four taps of each sample with its bilinear
// weights. The sample's taps, weights and validity come from the forward's
// own code (`SweepRay`), so they equal the forward's bit for bit; pose and
// intrinsics get no gradient (the RANSAC pose is stop-gradient).
// What bounds it: at the training shape (b = 4, 64x192 at 1/4 resolution,
// C = 32 bf16, 128 planes) it reads the 805 MB gradient once and writes
// two 3.1 MB maps, a 0.24 ms byte bound; but its warped half is 4 x 201 M
// weighted tap adds, and where those go to device memory one float32
// atomic each (the first design), they set the pace, contending in L2
// where neighbouring pixels share taps. So the adds stay on the SM: a block
// owns a tile of ref pixels of one batch item and walks the planes in
// groups; per group it bounds the taps its samples can touch from the
// tile's corner rays (a box of target pixels), adds the samples into a
// shared-memory copy of that box with shared atomics, and flushes the box
// to the accumulator with one 16-byte vector reduction (sm_90's
// atomicAdd(float4*)) per 4 channels of a box pixel. A group whose box does
// not fit, or whose corners are not all in front of the camera, and any
// sample whose taps leave the box by rounding, add straight to the
// accumulator with 16-byte vector reductions, 4x fewer operations than
// scalar atomics; correctness never rests on the box bound. The ref half
// is summed in registers, plane by plane in order, so dref is
// deterministic; the gradient is read with streaming loads, one plane
// ahead, so the 6.3 MB accumulator stays in L2. What bounds it now: the
// shared float32 atomics, which this card runs as compare-and-swap loops
// (ATOMS.CAST.SPIN in the SASS), one per weighted tap channel. Summing a
// run of planes on the same taps in registers first cost more in registers
// than it saved in atomics (b1_compare.py, PERF.md).
//
// dsfm_plane_sweep_volume_pose_grad -- the volume's gradient with respect
// to M and K t (the pose), for training PoseNet through PSNet's cost volume
// (pose.estimator = POSENET). It replaces the gradient XLA derives for the
// JAX package's cost volume with respect to the pose (deep_sfm_revisited_tpu/
// models/psnet.py:253-260; no Pallas kernel computed it), and follows
// jax.vjp of that volume: per valid sample, g_x = sum_c dvol_c d(blend)/dx
// from the four tgt taps' differences and g_y likewise, halved where the
// coordinate lies exactly on the frame's first or last row or column (the
// gradient of JAX's clip there), with a +1 tap beyond the frame read as zero
// (JAX's pad); then dp = (g_x / z, g_y / z, -(g_x x + g_y y) / z),
// dM_ij += dp_i d [u, v, 1]_j and dKt_i += dp_i. Taps, weights and validity
// come from `SweepRay`, so they are the forward's own; a sample the forward
// zeroed adds nothing. Plain version: ops/camera.py::
// plane_sweep_volume_pose_grad_plain.
// What bounds it: device-memory bytes. At the training shape it must read
// dvol's warped half, 4 x 128 x 64 x 192 x 32 bf16 = 402.7 MB (0.120 ms at
// 3.35 TB/s), for about 1.6 GFLOP; the 3.1 MB tgt map stays in L2. So a
// thread owns one 16-byte chunk of a pixel's warped half and walks the
// planes with streaming loads (the forward's mapping: a pixel's chunks are
// neighbouring threads); a pixel's lanes sum g_x, g_y with a butterfly of
// shuffles, and its first lane sums the six plane sums in float64 registers.
// The reduction runs in a fixed order, without atomics, so dM and dK t are
// the same bits from launch to launch: each block (a tile of one row of one
// batch item) sums its pixels' twelve terms in shared memory, in pixel
// order, into one partial of 12 doubles; a second kernel sums each batch
// item's partials, in a fixed tree, into dM and dK t.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// 16-byte chunk <-> floats, by bits, for each storage type.
struct F32 {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack16(uint4 r, float* v) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static void load16(const void* p, float* v) {
    unpack16(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  __device__ __forceinline__ static uint4 pack16(const float* v) {
    uint4 r;
    r.x = __float_as_uint(v[0]); r.y = __float_as_uint(v[1]);
    r.z = __float_as_uint(v[2]); r.w = __float_as_uint(v[3]);
    return r;
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
  __device__ __forceinline__ static void unpack16(uint4 r, float* v) {
    v[0] = lo(r.x); v[1] = hi(r.x); v[2] = lo(r.y); v[3] = hi(r.y);
    v[4] = lo(r.z); v[5] = hi(r.z); v[6] = lo(r.w); v[7] = hi(r.w);
  }
  __device__ __forceinline__ static void load16(const void* p, float* v) {
    unpack16(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  __device__ __forceinline__ static uint4 pack16(const float* v) {
    uint4 r;
    r.x = bits(v[0]) | (bits(v[1]) << 16); r.y = bits(v[2]) | (bits(v[3]) << 16);
    r.z = bits(v[4]) | (bits(v[5]) << 16); r.w = bits(v[6]) | (bits(v[7]) << 16);
    return r;
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

// The sweep's sample of ref pixel (x, y) of batch item b: the ray
// M [u, v, 1] once per pixel, then per plane depth d the point
// p = ray d + K t and the perspective divide, rounded op by op in the plain
// version's order (ops/camera.py::sweep_pixel_coords). The forward and the
// backward kernel both take their taps from here, so the backward scatters
// to the very taps, with the very weights, that the forward read.
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

// One 16-byte chunk (T::kVec channels from channel c0) of a sample of the
// NHWC image `img` (one batch item), blended into r.
template <typename T>
__device__ __forceinline__ void sample16(const char* img, const Taps& t, int C, int c0,
                                         float* r) {
  constexpr int kVec = T::kVec, kBytes = 16 / kVec;
  float v00[kVec], v01[kVec], v10[kVec], v11[kVec];
  T::load16(img + (t.i00 * C + c0) * kBytes, v00);
  T::load16(img + (t.i01 * C + c0) * kBytes, v01);
  T::load16(img + (t.i10 * C + c0) * kBytes, v10);
  T::load16(img + (t.i11 * C + c0) * kBytes, v11);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    r[k] = blend(v00[k], v01[k], v10[k], v11[k], t.wx, t.ax, t.wy, t.ay, t.valid);
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
  const Taps t(xy.x, xy.y, H, W);
  const int64_t base = (int64_t)b * H * W;
  const int64_t io = q * C + c0;

  if constexpr (VECTOR) {
    constexpr int kBytes = 16 / T::kVec;  // bytes per element
    float r[kVec];
    sample16<T>(reinterpret_cast<const char*>(img) + base * C * kBytes, t, C, c0, r);
    *reinterpret_cast<uint4*>(reinterpret_cast<char*>(out) + io * kBytes) = T::pack16(r);
  } else {
    const int64_t o = base * C + c0;
    const float v = blend(T::load1(img, o + t.i00 * C), T::load1(img, o + t.i01 * C),
                          T::load1(img, o + t.i10 * C), T::load1(img, o + t.i11 * C),
                          t.wx, t.ax, t.wy, t.ay, t.valid);
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


// ---------------------------------------------------------------------------
// The fused plane-sweep cost volume.

constexpr int kSweepThreads = 256;
constexpr int kPlanesPerItem = 8;   // planes a work item walks
constexpr int kMaxDevices = 64;

// ref, tgt (B, H, W, C) NHWC; depths (D,); M (B, 3, 3) = K R K^-1 and
// Kt (B, 3) = K t, row-major float32; out (B, D, H, W, 2C) = [ref | warped].
// A work item is (plane chunk, b, y, x tile); item = ((dc B + b) H + y)
// tiles + tile. Thread t of the block serves pixel t / tpp of the tile and
// channel chunk t % tpp of both halves (tpp = C / kVec threads per pixel).
template <typename T>
__global__ void __launch_bounds__(kSweepThreads)
plane_sweep_volume_kernel(const void* __restrict__ ref, const void* __restrict__ tgt,
                          const float* __restrict__ depths, const float* __restrict__ M,
                          const float* __restrict__ Kt, void* __restrict__ out,
                          int B, int D, int H, int W, int C, int tiles, int64_t items) {
  constexpr int kVec = T::kVec, kBytes = 16 / kVec;
  const int tpp = C / kVec;
  const int ppt = kSweepThreads / tpp;          // pixels per tile
  const int pix = threadIdx.x / tpp;
  const int c0 = (threadIdx.x - pix * tpp) * kVec;
  if (pix >= ppt) return;                       // only when tpp does not divide the block
  const int64_t plane_bytes = (int64_t)H * W * 2 * C * kBytes;

  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    int64_t r = item;
    const int tile = (int)(r % tiles); r /= tiles;
    const int y = (int)(r % H); r /= H;
    const int b = (int)(r % B);
    const int d0 = (int)(r / B) * kPlanesPerItem;
    const int x = tile * ppt + pix;
    if (x >= W) continue;

    // once per item: the ray M [u, v, 1], K t and the ref chunk
    const SweepRay ray(M, Kt, b, x, y);
    const int64_t pixel = ((int64_t)b * H + y) * W + x;
    const uint4 ref16 = __ldg(reinterpret_cast<const uint4*>(
        reinterpret_cast<const char*>(ref) + (pixel * C + c0) * kBytes));
    const char* img = reinterpret_cast<const char*>(tgt) + (int64_t)b * H * W * C * kBytes;
    char* dst = reinterpret_cast<char*>(out)
                + ((((int64_t)b * D + d0) * H + y) * W + x) * 2 * C * kBytes + c0 * kBytes;
    const int d_end = min(D, d0 + kPlanesPerItem);

#pragma unroll 2
    for (int d = d0; d < d_end; ++d, dst += plane_bytes) {
      float w16[kVec];
      sample16<T>(img, ray.taps(__ldg(depths + d), H, W), C, c0, w16);
      __stcs(reinterpret_cast<uint4*>(dst), ref16);
      __stcs(reinterpret_cast<uint4*>(dst + C * kBytes), T::pack16(w16));
    }
  }
}

template <typename T>
cudaError_t launch_sweep(const void* ref, const void* tgt, const float* depths,
                         const float* M, const float* Kt, void* out, int B, int D,
                         int H, int W, int C, cudaStream_t stream) {
  // the persistent grid: as many blocks as fit on the card at once, looked
  // up once per device
  static int blocks_on_card[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (blocks_on_card[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, plane_sweep_volume_kernel<T>, kSweepThreads, 0);
    if (err != cudaSuccess) return err;
    blocks_on_card[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int ppt = kSweepThreads / (C / T::kVec);
  const int tiles = (W + ppt - 1) / ppt;
  const int64_t items = (int64_t)((D + kPlanesPerItem - 1) / kPlanesPerItem) * B * H * tiles;
  const int64_t grid = items < blocks_on_card[dev] ? items : blocks_on_card[dev];
  plane_sweep_volume_kernel<T><<<(unsigned)grid, kSweepThreads, 0, stream>>>(
      ref, tgt, depths, M, Kt, out, B, D, H, W, C, tiles, items);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The plane sweep's backward.

constexpr int kBwdThreads = 256;       // the most threads a block may have
// the default work mapping, the fastest of those timed at slice 5's inputs
// (b1_compare.py): 16 planes a group, a 64 KB accumulator (512 box pixels
// at C = 32, three blocks an SM)
constexpr int kBwdPlanes = 16;         // planes of a group (default)
constexpr int kBwdSmemBytes = 64 * 1024;   // the shared accumulator (default)
constexpr int kBwdSmemMax = 200 * 1024;    // the largest a caller may ask for

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

// dvol (B, D, H, W, 2C) = the volume's gradient, in T; dref (B, H, W, C) in
// T; dtgt (B, H, W, C) float32, zeroed by the caller. A block owns a tile of
// tile_h x tile_w ref pixels of one batch item, `tpp` threads a pixel
// (thread k of a pixel owns channel chunk k); block = ((b tiles_y) + ty)
// tiles_x + tx. It walks the planes in groups of `planes`. Per group the
// first warp computes the group's box (`group_box`); on the shared path the
// block zeroes a box x C float32 accumulator in shared memory, adds every
// valid sample's four weighted taps into it with shared atomics, and
// flushes it to dtgt with one 16-byte vector reduction per 4 channels of a
// box pixel. A direct group, and any sample whose taps leave the box, adds
// to dtgt with 16-byte vector reductions per tap. The ref half is summed in
// registers, plane by plane in order (dref is deterministic). dtgt's sums
// are atomics in no fixed order, so its last bits vary between launches.
// stats, when not null, counts [shared groups, direct groups, samples that
// left their box, 16-byte global reductions].
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
plane_sweep_volume_backward_kernel(const void* __restrict__ dvol,
                                   const float* __restrict__ depths,
                                   const float* __restrict__ M, const float* __restrict__ Kt,
                                   void* __restrict__ dref, float* __restrict__ dtgt,
                                   int D, int H, int W, int C, int tile_h, int tile_w,
                                   int tiles_x, int tiles_y, int planes, int cap,
                                   unsigned long long* __restrict__ stats) {
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

  const SweepRay ray(M, Kt, b, in ? x : tx0, in ? y : ty0);
  const int64_t plane_bytes = (int64_t)H * W * 2 * C * kBytes;
  const int64_t pixel = ((int64_t)b * H + y) * W + x;
  const char* src = reinterpret_cast<const char*>(dvol)
                    + ((((int64_t)b * D * H) + y) * W + x) * 2 * C * kBytes + c0 * kBytes;
  float* const gacc = dtgt + (int64_t)b * H * W * C + c0;
  float rsum[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) rsum[k] = 0.f;
  unsigned long long left = 0, direct_ops = 0;

  for (int d0 = 0; d0 < D; d0 += planes) {
    const int d1 = min(D, d0 + planes);
    if (threadIdx.x < 32) {
      const GroupBox g = group_box(depths, M, Kt, b, d0, d1, tx0, ty0, tx1, ty1, H, W, cap,
                                   threadIdx.x);
      if (threadIdx.x == 0) {
        box = g;
        if (stats) atomicAdd(stats + (g.direct ? 1 : 0), 1ull);
      }
    }
    __syncthreads();
    const GroupBox g = box;
    const int n4 = g.w * g.h * C / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    if (in) {
      const char* s = src + d0 * plane_bytes;
      uint4 next_ref = __ldcs(reinterpret_cast<const uint4*>(s));
      uint4 next_warp = __ldcs(reinterpret_cast<const uint4*>(s + C * kBytes));
      for (int d = d0; d < d1; ++d) {
        // streaming loads, one plane ahead: the gradient must not evict the
        // accumulator from L2
        const uint4 cur_ref = next_ref, cur_warp = next_warp;
        if (d + 1 < d1) {
          s += plane_bytes;
          next_ref = __ldcs(reinterpret_cast<const uint4*>(s));
          next_warp = __ldcs(reinterpret_cast<const uint4*>(s + C * kBytes));
        }
        float gv[kVec];
        T::unpack16(cur_ref, gv);
#pragma unroll
        for (int k = 0; k < kVec; ++k) rsum[k] = __fadd_rn(rsum[k], gv[k]);
        const Taps t = ray.taps(__ldg(depths + d), H, W);
        if (t.valid == 0.f) continue;
        T::unpack16(cur_warp, gv);
        const float w00 = __fmul_rn(t.ay, t.ax), w01 = __fmul_rn(t.ay, t.wx);
        const float w10 = __fmul_rn(t.wy, t.ax), w11 = __fmul_rn(t.wy, t.wx);
        if (t.xi >= g.x0 && t.xi1 < g.x0 + g.w && t.yi >= g.y0 && t.yi1 < g.y0 + g.h) {
          const int q00 = (t.yi - g.y0) * g.w + (t.xi - g.x0);
          const int q01 = q00 + (t.xi1 - t.xi), q10 = q00 + (t.yi1 - t.yi) * g.w;
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
          if (stats) {
            left += g.direct ? 0 : (c0 == 0);
            direct_ops += kVec;   // 4 taps x kVec / 4
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const int q = i / (C / 4), c = (i - q * (C / 4)) * 4;
      const float4 v = make_float4(acc[smem_slot(q, c, C)], acc[smem_slot(q, c + 1, C)],
                                   acc[smem_slot(q, c + 2, C)], acc[smem_slot(q, c + 3, C)]);
      const int yy = g.y0 + q / g.w, xx = g.x0 + q % g.w;
      atomicAdd(reinterpret_cast<float4*>(dtgt + ((((int64_t)b * H + yy) * W + xx) * C + c)), v);
    }
    if (stats && threadIdx.x == 0) atomicAdd(stats + 3, (unsigned long long)n4);
    __syncthreads();
  }
  if (stats) {
    if (left) atomicAdd(stats + 2, left);
    if (direct_ops) atomicAdd(stats + 3, direct_ops);
  }
  if (in)
    *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dref) + (pixel * C + c0) * kBytes) =
        T::pack16(rsum);
}

// The default tile: about 256 threads, as square as a power-of-two width
// allows (8 x 8 pixels at 4 threads a pixel).
__host__ inline void default_tile(int tpp, int* tile_h, int* tile_w) {
  const int ppt = kBwdThreads / tpp > 0 ? kBwdThreads / tpp : 1;
  int w = 1;
  while (w * w < ppt) w *= 2;
  *tile_w = w < ppt ? w : ppt;
  *tile_h = ppt / *tile_w;
}

template <typename T>
cudaError_t launch_sweep_backward(const void* dvol, const float* depths, const float* M,
                                  const float* Kt, void* dref, float* dtgt, int B, int D,
                                  int H, int W, int C, int tile_h, int tile_w, int planes,
                                  int smem_bytes, unsigned long long* stats,
                                  cudaStream_t stream) {
  static bool opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {   // shared accumulators above 48 KB, once per device
    err = cudaFuncSetAttribute(plane_sweep_volume_backward_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemMax);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const int tpp = C / T::kVec;
  if (tile_h <= 0 || tile_w <= 0) default_tile(tpp, &tile_h, &tile_w);
  if (planes <= 0) planes = kBwdPlanes;
  if (smem_bytes <= 0) smem_bytes = kBwdSmemBytes;
  const int64_t threads = (int64_t)tile_h * tile_w * tpp;
  if (threads < 32 || threads > kBwdThreads || smem_bytes > kBwdSmemMax)
    return cudaErrorInvalidConfiguration;
  const int tiles_x = (W + tile_w - 1) / tile_w, tiles_y = (H + tile_h - 1) / tile_h;
  const int64_t blocks = (int64_t)B * tiles_y * tiles_x;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int cap = smem_bytes / (C * 4);
  plane_sweep_volume_backward_kernel<T><<<(unsigned)blocks, (unsigned)threads, smem_bytes,
                                          stream>>>(
      dvol, depths, M, Kt, dref, dtgt, D, H, W, C, tile_h, tile_w, tiles_x, tiles_y, planes,
      cap, stats);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The plane sweep's pose gradient.

constexpr int kPoseThreads = 256;     // threads of a block of the first pass
constexpr int kPoseReduceThreads = 256;
constexpr int kPoseTerms = 12;        // dM (row-major 3 x 3), then dKt (3)

// The pixels of one tile: a block serves ppt = 256 / tpp pixels of one row
// of one batch item, tpp = C / kVec threads a pixel (a power of two up to 32,
// so a pixel's lanes lie in one warp). block = (b H + y) tiles + tile.
template <typename T>
__global__ void __launch_bounds__(kPoseThreads)
plane_sweep_pose_grad_kernel(const void* __restrict__ dvol, const void* __restrict__ tgt,
                             const float* __restrict__ depths, const float* __restrict__ M,
                             const float* __restrict__ Kt, double* __restrict__ partial,
                             int D, int H, int W, int C, int tiles) {
  constexpr int kVec = T::kVec, kBytes = 16 / kVec;
  __shared__ double terms[kPoseThreads][kPoseTerms];   // one row a pixel
  const int tpp = C / kVec;
  const int ppt = kPoseThreads / tpp;
  const int pix = threadIdx.x / tpp, lane = threadIdx.x - pix * tpp;
  const int c0 = lane * kVec;
  int r = blockIdx.x;
  const int tile = r % tiles; r /= tiles;
  const int y = r % H;
  const int b = r / H;
  const int x = tile * ppt + pix;
  const bool in = x < W;           // lanes past the row's end still shuffle
  const int xc = in ? x : W - 1;
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);

  const SweepRay ray(M, Kt, b, xc, y);
  const char* img = reinterpret_cast<const char*>(tgt) + (int64_t)b * H * W * C * kBytes;
  const int64_t plane_bytes = (int64_t)H * W * 2 * C * kBytes;
  const char* g = reinterpret_cast<const char*>(dvol)
                  + ((((int64_t)b * D * H + y) * W + xc) * 2 * C + C + c0) * kBytes;
  double s[3] = {0.0, 0.0, 0.0}, t[3] = {0.0, 0.0, 0.0};   // sum_d dp_i d, sum_d dp_i

#pragma unroll 2
  for (int d = 0; d < D; ++d, g += plane_bytes) {
    const float dep = __ldg(depths + d);
    float p[3];
    ray.point(dep, p);
    const bool behind = p[2] <= 1e-3f;
    const float z = fmaxf(p[2], 1e-3f);
    const float xs = behind ? (float)(2 * W) : __fdiv_rn(p[0], z);
    const float ys = behind ? (float)(2 * H) : __fdiv_rn(p[1], z);
    const Taps tp(xs, ys, H, W);
    const bool valid = in && tp.valid != 0.f;
    float gx = 0.f, gy = 0.f;
    if (valid) {
      float gv[kVec], v00[kVec], v01[kVec], v10[kVec], v11[kVec];
      T::unpack16(__ldcs(reinterpret_cast<const uint4*>(g)), gv);
      const bool x1 = tp.xi + 1 < W, y1 = tp.yi + 1 < H;   // else JAX's zero pad
      T::load16(img + (tp.i00 * C + c0) * kBytes, v00);
#pragma unroll
      for (int k = 0; k < kVec; ++k) v01[k] = v10[k] = v11[k] = 0.f;
      if (x1) T::load16(img + (tp.i01 * C + c0) * kBytes, v01);
      if (y1) T::load16(img + (tp.i10 * C + c0) * kBytes, v10);
      if (x1 && y1) T::load16(img + (tp.i11 * C + c0) * kBytes, v11);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float dx = __fadd_rn(__fmul_rn(__fsub_rn(v01[k], v00[k]), tp.ay),
                                   __fmul_rn(__fsub_rn(v11[k], v10[k]), tp.wy));
        const float dy = __fadd_rn(__fmul_rn(__fsub_rn(v10[k], v00[k]), tp.ax),
                                   __fmul_rn(__fsub_rn(v11[k], v01[k]), tp.wx));
        gx = __fadd_rn(gx, __fmul_rn(gv[k], dx));
        gy = __fadd_rn(gy, __fmul_rn(gv[k], dy));
      }
    }
    // the pixel's sum over its channel chunks, the same tree on every lane
    for (int o = tpp >> 1; o > 0; o >>= 1) {
      gx += __shfl_xor_sync(0xffffffffu, gx, o);
      gy += __shfl_xor_sync(0xffffffffu, gy, o);
    }
    if (valid && lane == 0) {
      const double GX = (double)gx * ((xs == 0.f || xs == wm1) ? 0.5 : 1.0);
      const double GY = (double)gy * ((ys == 0.f || ys == hm1) ? 0.5 : 1.0);
      const double zd = (double)z;
      const double dp[3] = {GX / zd, GY / zd, -(GX * (double)xs + GY * (double)ys) / zd};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s[i] += dp[i] * (double)dep;
        t[i] += dp[i];
      }
    }
  }
  if (lane == 0) {
    const double u = in ? (double)x : 0.0, v = (double)y;
    double* row = terms[pix];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      row[3 * i] = s[i] * u;
      row[3 * i + 1] = s[i] * v;
      row[3 * i + 2] = s[i];
      row[9 + i] = t[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < kPoseTerms) {    // the block's partial, in pixel order
    double acc = 0.0;
    for (int q = 0; q < ppt; ++q) acc += terms[q][threadIdx.x];
    partial[(int64_t)blockIdx.x * kPoseTerms + threadIdx.x] = acc;
  }
}

// One block a batch item: thread k sums partials k, k + 256, ... of the
// item's `per_b` blocks in order, then a fixed tree in shared memory.
__global__ void __launch_bounds__(kPoseReduceThreads)
plane_sweep_pose_grad_reduce(const double* __restrict__ partial, float* __restrict__ dM,
                             float* __restrict__ dKt, int per_b) {
  __shared__ double sum[kPoseReduceThreads][kPoseTerms];
  const int b = blockIdx.x;
  double acc[kPoseTerms];
#pragma unroll
  for (int j = 0; j < kPoseTerms; ++j) acc[j] = 0.0;
  for (int k = threadIdx.x; k < per_b; k += kPoseReduceThreads) {
    const double* p = partial + ((int64_t)b * per_b + k) * kPoseTerms;
#pragma unroll
    for (int j = 0; j < kPoseTerms; ++j) acc[j] += p[j];
  }
#pragma unroll
  for (int j = 0; j < kPoseTerms; ++j) sum[threadIdx.x][j] = acc[j];
  __syncthreads();
  for (int half = kPoseReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int j = 0; j < kPoseTerms; ++j) sum[threadIdx.x][j] += sum[threadIdx.x + half][j];
    }
    __syncthreads();
  }
  if (threadIdx.x < 9) dM[9 * b + threadIdx.x] = (float)sum[0][threadIdx.x];
  else if (threadIdx.x < kPoseTerms) dKt[3 * b + threadIdx.x - 9] = (float)sum[0][threadIdx.x];
}

// The first pass's block count (the partials' rows), or -1 where the
// channel chunks of a pixel are not a power of two up to 32.
__host__ inline int64_t pose_grad_blocks(int B, int H, int W, int C, int kvec, int* tiles) {
  const int tpp = C / kvec;
  if (C % kvec != 0 || tpp < 1 || tpp > 32 || (tpp & (tpp - 1)) != 0) return -1;
  const int ppt = kPoseThreads / tpp;
  *tiles = (W + ppt - 1) / ppt;
  return (int64_t)B * H * *tiles;
}

template <typename T>
cudaError_t launch_pose_grad(const void* dvol, const void* tgt, const float* depths,
                             const float* M, const float* Kt, double* partial, float* dM,
                             float* dKt, int B, int D, int H, int W, int C,
                             cudaStream_t stream) {
  int tiles = 0;
  const int64_t blocks = pose_grad_blocks(B, H, W, C, T::kVec, &tiles);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  plane_sweep_pose_grad_kernel<T><<<(unsigned)blocks, kPoseThreads, 0, stream>>>(
      dvol, tgt, depths, M, Kt, partial, D, H, W, C, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  plane_sweep_pose_grad_reduce<<<B, kPoseReduceThreads, 0, stream>>>(
      partial, dM, dKt, (int)(blocks / B));
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

// The cost volume out (B, D, H, W, 2C) of ref and tgt (B, H, W, C), both of
// `dtype` (0 = float32, 1 = bfloat16), at plane depths (D,), with M (B, 3, 3)
// and Kt (B, 3) float32 on the device. The wrapper checks that ref, tgt and
// out are 16-byte aligned, C * itemsize is a multiple of 16 and at most
// 16 * 256 bytes, and that B, D, H, W are positive.
extern "C" int dsfm_plane_sweep_volume(const void* ref, const void* tgt, const void* depths,
                                       const void* M, const void* Kt, void* out, int B,
                                       int D, int H, int W, int C, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* dp = reinterpret_cast<const float*>(depths);
  const float* mp = reinterpret_cast<const float*>(M);
  const float* kp = reinterpret_cast<const float*>(Kt);
  if (dtype == 0) return launch_sweep<F32>(ref, tgt, dp, mp, kp, out, B, D, H, W, C, s);
  if (dtype == 1) return launch_sweep<BF16>(ref, tgt, dp, mp, kp, out, B, D, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// The same, with the work mapping given (0 takes the default: an 8 x 8
// tile at 4 threads a pixel, 16 planes a group, a 64 KB shared accumulator)
// and, where `stats` (4 x uint64 on the device, zeroed) is not null, the
// counts [shared groups, direct groups, samples that left their box,
// 16-byte global reductions]: what chip_smoke.py reports and the tuning
// runs vary.
extern "C" int dsfm_plane_sweep_volume_backward_probe(const void* dvol, const void* depths,
                                                      const void* M, const void* Kt,
                                                      void* dref, void* dtgt, int B, int D,
                                                      int H, int W, int C, int dtype,
                                                      int tile_h, int tile_w, int planes,
                                                      int smem_bytes, void* stats,
                                                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* dp = reinterpret_cast<const float*>(depths);
  const float* mp = reinterpret_cast<const float*>(M);
  const float* kp = reinterpret_cast<const float*>(Kt);
  float* acc = reinterpret_cast<float*>(dtgt);
  unsigned long long* st = reinterpret_cast<unsigned long long*>(stats);
  if (dtype == 0)
    return launch_sweep_backward<F32>(dvol, dp, mp, kp, dref, acc, B, D, H, W, C, tile_h,
                                      tile_w, planes, smem_bytes, st, s);
  if (dtype == 1)
    return launch_sweep_backward<BF16>(dvol, dp, mp, kp, dref, acc, B, D, H, W, C, tile_h,
                                       tile_w, planes, smem_bytes, st, s);
  return (int)cudaErrorInvalidValue;
}

// The sweep's backward: given dvol (B, D, H, W, 2C) of `dtype`, dref
// (B, H, W, C) of `dtype` = the sum of dvol's ref half over D, and dtgt
// (B, H, W, C) float32, zeroed by the caller, += the warped half scattered
// onto the taps. The same alignment and size rules as the forward.
extern "C" int dsfm_plane_sweep_volume_backward(const void* dvol, const void* depths,
                                                const void* M, const void* Kt, void* dref,
                                                void* dtgt, int B, int D, int H, int W, int C,
                                                int dtype, void* stream) {
  return dsfm_plane_sweep_volume_backward_probe(dvol, depths, M, Kt, dref, dtgt, B, D, H, W, C,
                                                dtype, 0, 0, 0, 0, nullptr, stream);
}

// The rows of the pose gradient's partials (12 doubles each) for B, H, W, C
// of `dtype`, or -1 where the kernel does not take C.
extern "C" long long dsfm_plane_sweep_volume_pose_grad_blocks(int B, int H, int W, int C,
                                                              int dtype) {
  int tiles = 0;
  if (dtype != 0 && dtype != 1) return -1;
  return pose_grad_blocks(B, H, W, C, dtype == 0 ? F32::kVec : BF16::kVec, &tiles);
}

// The sweep's pose gradient: given dvol (B, D, H, W, 2C) and tgt (B, H, W, C)
// of `dtype`, depths (D,), M (B, 3, 3), Kt (B, 3) float32, and the partials
// (blocks x 12 doubles, from dsfm_plane_sweep_volume_pose_grad_blocks),
// writes dM (B, 3, 3) and dKt (B, 3) float32. The same alignment rules as
// the forward; C * itemsize / 16 a power of two up to 32.
extern "C" int dsfm_plane_sweep_volume_pose_grad(const void* dvol, const void* tgt,
                                                 const void* depths, const void* M,
                                                 const void* Kt, void* partial, void* dM,
                                                 void* dKt, int B, int D, int H, int W, int C,
                                                 int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* dp = reinterpret_cast<const float*>(depths);
  const float* mp = reinterpret_cast<const float*>(M);
  const float* kp = reinterpret_cast<const float*>(Kt);
  double* part = reinterpret_cast<double*>(partial);
  float* om = reinterpret_cast<float*>(dM);
  float* ok = reinterpret_cast<float*>(dKt);
  if (dtype == 0)
    return launch_pose_grad<F32>(dvol, tgt, dp, mp, kp, part, om, ok, B, D, H, W, C, s);
  if (dtype == 1)
    return launch_pose_grad<BF16>(dvol, tgt, dp, mp, kp, part, om, ok, B, D, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
