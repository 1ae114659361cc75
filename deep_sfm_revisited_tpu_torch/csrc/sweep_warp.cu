// Kernel B1: bilinear gather for PWC-DC's flow warps, DICL's fused warp and
// displacement volume, and the fused plane-sweep cost volume of PSNet with
// its two gradients, written for Hopper (sm_90a).
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
// Six entry points share that rule (`Taps` and `blend` in bilinear.cuh, `SweepRay` in sweep.cuh):
//
// dsfm_bilinear_sample -- the generic gather at given coordinates, used by
// PWC-DC's flow warps. One thread per (query, 16-byte channel chunk), so
// neighbouring threads read and write neighbouring 16-byte chunks and every
// store is a full, coalesced 16-byte vector. The warps are small (at most
// 96x320 queries) and launch-bound, so every entry point is launched
// through PyTorch operators (sweep_warp_ops.cpp), not from Python.
//
// dsfm_displacement_volume -- DICL's (B, S2, 2C, h, w) displacement stack
// of one pyramid level, S = 2 md + 1: per ref pixel p and displacement
// d = (du, dv) (dv outer), the pair [x m hole | ys m hole], where ys is y
// warped by the level's flow (B1's gather at q + flow(q), q = p + d,
// rounded to y's dtype) or y itself at the coarsest level, m is 1 where q
// lies in the frame and hole is 1 where some channel of ys is non-zero
// (models/dicl.py::shifted_pairs of warp_flow, JAX models/dicl.py:160-188,
// :231-239; the TPU ran that stack as XLA-fused jnp around
// bilinear_sample). It replaces ~500 eager launches a level.
// What bounds it: device-memory bytes. At slice 1 (b = 1, 384x1280, C = 32
// bf16, md = 3) the level-2 stack is 49 x 64 x 96 x 320 x 2 B = 192.7 MB,
// ~262 MB over the five levels (0.078 ms at 3.35 TB/s), against ~2 MB of
// maps, so every choice serves the store stream. The pair at (s, p) is
// [x(p) K(q) | ys(q)] with one flag map K (q in the frame and ys(q) not
// all zero): the y half of the centre displacement is ys itself, and every
// other plane is x or ys shifted by d and masked by K. So:
// - with a flow, a first launch (displacement_volume_sample) samples ys
//   once, a pixel and 8 channels a thread, into the centre displacement's
//   y half, where it belongs; the store kernel reads it back from L2;
// - the store kernel's item is (b, dv, a band of rows, a tile -- the whole
//   width where it fits): cp.async stages the band's ys rows (every
//   channel, 8 elements of halo each side) into shared memory, double
//   buffered, so the next item's rows arrive while this one stores; the K
//   words of the band come from those rows (8 lanes a word, OR-ed
//   magnitude bits, shuffles); then all 2C planes x 2 md + 1 du of the band
//   are stored as 16-byte streaming stores, neighbouring threads on
//   neighbouring chunks, so a plane's band is one contiguous run;
// - the ys window of each du comes from three aligned 16-byte shared loads
//   a unit, shifted in registers (du unrolled), not from 2-byte loads;
// - the work mapping is chosen in Python per level shape
//   (ops/cuda/sweep_warp.py::displacement_plan, measured by
//   b1_compare.py --volume-plans): bands of 1-4 rows keep items within
//   384 KB of output and the level at half a round of resident blocks or
//   more; at the coarse levels, where one item a block samples as fast as a
//   second launch could, the store kernel samples y itself (`fused`).
// `nvcc -Xptxas -v` (sm_90a): the store kernel's 16-byte instantiations 128
// registers (their launch bound: two 256-thread blocks an SM) with 8-24
// bytes of spills, the sample kernel 40 registers; shared memory per level
// 4-66 KB. What bounds it now (PERF.md): at level 2 the store kernel runs
// at ~82% of a plain fill of the same bytes, and the sample launch adds
// ~7.6 us; the coarse levels are one round of blocks behind a launch.
// m and hole are 0 or 1, so x m hole is x (m hole) bit for bit: the stack
// is bit-identical to the plain composition in bf16 and float32.
//
// dsfm_displacement_volume_backward -- the displacement volume's gradient
// with respect to x and y, for training DICL (flow pretraining). It
// replaces the gradient XLA derives for the JAX package's stack
// (models/dicl.py:160-188 of warp_flow, :231-239); DICL detaches the flow
// it warps with (JAX models/dicl.py:348), so there is no flow gradient.
// Given dout: dx[p] = sum_s keep_s(p) dout[s, c, p]; the gradient of the
// warped y at q is hole(q) sum_s dout[s, C + c, q - d_s] over the p = q -
// d_s in the frame; without a flow that is dy, with one it goes to the four
// taps of q's sample with the forward's bilinear weights and validity
// (`Taps`), float32 atomics into a float32 buffer cast once.
// What bounds it: device-memory bytes. At the flow-training step (b = 4,
// 256x768, C = 32 bf16, md = 3) it must read the dout elements the data
// needs once, ~389 MB over the five levels (0.116 ms at 3.35 TB/s), against
// a few MB of maps and flows. The first design (one thread a pixel, 98
// dependent 2-byte loads behind a byte load and a branch on a hole array a
// separate launch wrote) kept too few bytes in flight: 21% of the bound.
// This one changes what a load carries: a warp owns 4 rows x 8 runs of V =
// 16 / itemsize pixels of one channel, so each lane reads its x half as one
// 16-byte vector a displacement and its y half, shifted by -du, as two
// (its own run and a neighbour's, shifted in registers), with du unrolled
// so a lane issues a displacement row's 3 S loads together; the hole flags
// of the tile and its md halo are computed once by the block (the
// forward's code) into shared-memory bits, so a mask is a bit test and a
// select, not a load and a branch, and there is no hole launch. With a
// flow, a memset zeroes the float32 buffer first, and in bfloat16 a cast
// follows. `nvcc -Xptxas -v` (sm_90a): the training step's instantiation
// (bf16, md 3, vectors) takes 149 registers, no spills, 160 bytes of shared
// memory (the flag bits), one 256-thread block an SM (its launch bound);
// the scalar path (w not a multiple of the run) up to 255, no spills. What
// bounds it now: memory latency, not bytes -- the coarse levels are one
// wave of blocks that each wait 7 rows in series behind the prologue, and
// level 2 reaches 54% of its byte bound (the step 45%); with a flow, a
// memset and, in bf16, a cast per level add ~0.015 ms a step (PERF.md).
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
// What bounds it: device-memory bytes. At the POSENET step's inputs it must
// read dvol's warped half where the sample is valid (49% of 4 x 128 x 64 x
// 192 x 32 bf16, 201.5 MB: 0.060 ms at 3.35 TB/s), for about 1.5 GFLOP; the
// 3.1 MB tgt map stays in L2. A thread owns one 16-byte chunk of a pixel's
// warped half (the forward's mapping: a pixel's chunks are neighbouring
// threads). The first design walked all 128 planes in one thread behind 768
// blocks (less than one wave), issued each plane's load after its two
// divisions, and left the float64 chain to one lane (0.3133 ms). Now a
// block owns one row tile and a group of 32 planes (3072 blocks at that
// shape), and walks its group in rings of min(tpp, 8) planes (4 in bf16):
// lane j of a pixel computes plane j's coordinates, validity and taps once
// and passes them to the pixel's other lanes by shuffles, then all the
// ring's dvol loads are issued (streaming), then the taps and the chunk
// sums; a pixel's lanes sum g_x, g_y with a butterfly of shuffles, and
// lane j runs plane j's float64 chain, with 1/z once a sample. Most of its
// time is instructions, not bytes: the per-channel tap arithmetic of the
// valid samples (in fused multiply-adds) and the per-sample coordinates.
// The reduction runs in a fixed order, without atomics, so dM and dK t are
// the same bits from launch to launch:
// each warp sums its pixels' twelve terms by shuffles in a fixed tree, the
// block its warps in order, into one partial of 12 doubles per (tile, plane
// group); a second kernel sums each batch item's partials, in a fixed
// tree, into dM and dK t.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "bilinear.cuh"   // Taps, blend: the sampling rule B2's warped entry shares
#include "sweep.cuh"      // SweepRay, group_box, red16: shared with sweep_corr.cu

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
  // one element as stored, and the displacement volume's pair accesses
  using Bits = float;
  __device__ __forceinline__ static float to_float(Bits b) { return b; }
  __device__ __forceinline__ static Bits from_float(float v) { return v; }
  __device__ __forceinline__ static Bits load_bits(const void* p, int64_t i) {
    return __ldg(reinterpret_cast<const float*>(p) + i);
  }
  __device__ __forceinline__ static void load2(const void* p, int64_t i, float& a, float& b) {
    const float2 r =
        __ldg(reinterpret_cast<const float2*>(reinterpret_cast<const float*>(p) + i));
    a = r.x;
    b = r.y;
  }
  __device__ __forceinline__ static void store1cs(void* p, int64_t i, float v) {
    __stcs(reinterpret_cast<float*>(p) + i, v);
  }
  __device__ __forceinline__ static void store2cs(void* p, int64_t i, float a, float b) {
    __stcs(reinterpret_cast<float2*>(reinterpret_cast<float*>(p) + i), make_float2(a, b));
  }
  // the bits of an element's value times 0
  __device__ __forceinline__ static uint32_t times_zero(uint32_t b) {
    return __float_as_uint(__fmul_rn(__uint_as_float(b), 0.f));
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
  using Bits = unsigned short;
  __device__ __forceinline__ static float to_float(Bits b) {
    return __uint_as_float(((uint32_t)b) << 16);
  }
  __device__ __forceinline__ static Bits from_float(float v) { return (Bits)bits(v); }
  __device__ __forceinline__ static Bits load_bits(const void* p, int64_t i) {
    return __ldg(reinterpret_cast<const unsigned short*>(p) + i);
  }
  __device__ __forceinline__ static void load2(const void* p, int64_t i, float& a, float& b) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(
        reinterpret_cast<const unsigned short*>(p) + i));
    a = lo(w);
    b = hi(w);
  }
  __device__ __forceinline__ static void store1cs(void* p, int64_t i, float v) {
    __stcs(reinterpret_cast<unsigned short*>(p) + i, (unsigned short)bits(v));
  }
  __device__ __forceinline__ static void store2cs(void* p, int64_t i, float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);   // a at the lower address
    __stcs(reinterpret_cast<unsigned int*>(reinterpret_cast<unsigned short*>(p) + i),
           *reinterpret_cast<const unsigned int*>(&v));
  }
  __device__ __forceinline__ static uint32_t times_zero(uint32_t b) {
    return bits(__fmul_rn(__uint_as_float(b << 16), 0.f));
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
constexpr int kPosePlanes = 32;       // planes of a block's group

// Block = ((b H + y) tiles + tile) groups + group: ppt = 256 / tpp pixels of
// one row of one batch item, tpp = C / kVec threads a pixel (a power of two
// up to 32, so a pixel's lanes lie in one warp), and plane group `group`
// (kPosePlanes planes). It walks its group in rings of kRing = min(tpp, 8)
// planes: lane j < kRing of a pixel computes plane j's point, divide,
// validity and taps, and sends them to the pixel's other lanes; all the
// ring's dvol loads are issued before any tap arithmetic; after the channel
// sums, lane j runs plane j's float64 chain. The block's partial, 12
// doubles, is row blockIdx.x, so a batch item's partials are one contiguous
// run in a fixed order.
// Three blocks an SM (<= 85 registers), which timed faster than two at
// 122 registers or four at 64.
template <typename T, int kRing>
__global__ void __launch_bounds__(kPoseThreads, 3)
plane_sweep_pose_grad_kernel(const void* __restrict__ dvol, const void* __restrict__ tgt,
                             const float* __restrict__ depths, const float* __restrict__ M,
                             const float* __restrict__ Kt, double* __restrict__ partial,
                             int D, int H, int W, int C, int tiles, int groups) {
  constexpr int kVec = T::kVec, kBytes = 16 / kVec;
  __shared__ double warp_terms[kPoseThreads / 32][kPoseTerms];
  const int tpp = C / kVec;
  const int ppt = kPoseThreads / tpp;
  const int pix = threadIdx.x / tpp, lane = threadIdx.x - pix * tpp;
  const int c0 = lane * kVec;
  int r = blockIdx.x;
  const int group = r % groups; r /= groups;
  const int tile = r % tiles; r /= tiles;
  const int y = r % H;
  const int b = r / H;
  const int x = tile * ppt + pix;
  const bool in = x < W;           // lanes past the row's end still shuffle
  const int xc = in ? x : W - 1;
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);

  const SweepRay ray(M, Kt, b, xc, y);
  const char* img = reinterpret_cast<const char*>(tgt) + (int64_t)b * H * W * C * kBytes
                    + c0 * kBytes;
  const int64_t plane_bytes = (int64_t)H * W * 2 * C * kBytes;
  const int d0 = group * kPosePlanes, d1 = min(D, d0 + kPosePlanes);
  const char* g = reinterpret_cast<const char*>(dvol)
                  + (((((int64_t)b * D + d0) * H + y) * W + xc) * 2 * C + C + c0) * kBytes;
  // lane j's planes: sum_d dp_k d and sum_d dp_k, k = 0, 1, 2
  double s[3] = {0.0, 0.0, 0.0}, t[3] = {0.0, 0.0, 0.0};

  for (int db = d0; db < d1; db += kRing, g += kRing * plane_bytes) {
    // 1. this lane's plane of the ring: point, divide and validity, as the
    //    forward's; its taps as one packed word: tap offset << 4 | the +1
    //    taps' presence (bits 0, 1) | the half-gradient edges (bits 2, 3),
    //    or -1 where the sample is invalid
    const int dmine = db + (lane < kRing ? lane : 0);
    const float dep = dmine < d1 ? __ldg(depths + dmine) : 0.f;
    float p[3];
    ray.point(dep, p);
    const bool behind = p[2] <= 1e-3f;
    const float z = fmaxf(p[2], 1e-3f);
    const float xs = behind ? (float)(2 * W) : __fdiv_rn(p[0], z);
    const float ys = behind ? (float)(2 * H) : __fdiv_rn(p[1], z);
    int word = -1;
    float wx = 0.f, wy = 0.f;
    if (in && dmine < d1 && xs >= 0.f && xs <= wm1 && ys >= 0.f && ys <= hm1) {
      const Taps tp(xs, ys, H, W);
      wx = tp.wx;
      wy = tp.wy;
      word = ((tp.yi * W + tp.xi) << 4) | (tp.xi + 1 < W ? 1 : 0) | (tp.yi + 1 < H ? 2 : 0)
             | (xs == 0.f || xs == wm1 ? 4 : 0) | (ys == 0.f || ys == hm1 ? 8 : 0);
    }
    int words[kRing];
    float wxs[kRing], wys[kRing];
#pragma unroll
    for (int j = 0; j < kRing; ++j) {
      words[j] = __shfl_sync(0xffffffffu, word, j, tpp);
      wxs[j] = __shfl_sync(0xffffffffu, wx, j, tpp);
      wys[j] = __shfl_sync(0xffffffffu, wy, j, tpp);
    }
    // 2. every valid sample's dvol chunk, all in flight before any tap
    uint4 gv[kRing];
#pragma unroll
    for (int j = 0; j < kRing; ++j)
      gv[j] = words[j] >= 0 ? __ldcs(reinterpret_cast<const uint4*>(g + j * plane_bytes))
                            : make_uint4(0u, 0u, 0u, 0u);
    // 3. the taps and the chunk's sums (a +1 tap beyond the frame reads as
    //    zero, JAX's pad): g_x = ay (S01 - S00) + wy (S11 - S10) and g_y =
    //    ax (S10 - S00) + wx (S11 - S01), S_t the chunk's dot product of the
    //    gradient with tap t, four fused multiply-adds a channel
    float gx[kRing], gy[kRing];
#pragma unroll
    for (int j = 0; j < kRing; ++j) {
      gx[j] = gy[j] = 0.f;
      const int wd = words[j];
      if (wd < 0) continue;
      const int64_t q = (int64_t)(wd >> 4) * C * kBytes;
      const float tx = wxs[j], ty = wys[j], ax = __fsub_rn(1.f, tx), ay = __fsub_rn(1.f, ty);
      float gf[kVec], v00[kVec], v01[kVec], v10[kVec], v11[kVec];
      T::unpack16(gv[j], gf);
      T::load16(img + q, v00);
#pragma unroll
      for (int k = 0; k < kVec; ++k) v01[k] = v10[k] = v11[k] = 0.f;
      const int64_t row = (int64_t)W * C * kBytes, col = C * kBytes;
      if (wd & 1) T::load16(img + q + col, v01);
      if (wd & 2) T::load16(img + q + row, v10);
      if ((wd & 3) == 3) T::load16(img + q + row + col, v11);
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        s00 = fmaf(gf[k], v00[k], s00);
        s01 = fmaf(gf[k], v01[k], s01);
        s10 = fmaf(gf[k], v10[k], s10);
        s11 = fmaf(gf[k], v11[k], s11);
      }
      gx[j] = fmaf(ay, s01 - s00, ty * (s11 - s10));
      gy[j] = fmaf(ax, s10 - s00, tx * (s11 - s01));
    }
    // 4. the pixel's sums over its channel chunks, the same tree on every lane
#pragma unroll
    for (int j = 0; j < kRing; ++j) {
      for (int o = tpp >> 1; o > 0; o >>= 1) {
        gx[j] += __shfl_xor_sync(0xffffffffu, gx[j], o);
        gy[j] += __shfl_xor_sync(0xffffffffu, gy[j], o);
      }
    }
    // 5. lane j: plane j's float64 chain, with 1/z once
    float gxm = 0.f, gym = 0.f;
#pragma unroll
    for (int j = 0; j < kRing; ++j) {
      if (lane == j) {
        gxm = gx[j];
        gym = gy[j];
      }
    }
    if (lane < kRing && word >= 0) {
      const double GX = (double)gxm * ((word & 4) ? 0.5 : 1.0);
      const double GY = (double)gym * ((word & 8) ? 0.5 : 1.0);
      const double rz = 1.0 / (double)z;
      const double dp[3] = {GX * rz, GY * rz, -(GX * (double)xs + GY * (double)ys) * rz};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[k] += dp[k] * (double)dep;
        t[k] += dp[k];
      }
    }
  }

  // the block's partial, in a fixed tree: the pixel's lanes sum their six
  // sums by shuffles; lane l of the pixel then carries terms l, l + tpp, ...
  // and the warp sums them over its pixels by shuffles between lanes of the
  // same rank; the first 12 threads sum the warps in order
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    for (int o = tpp >> 1; o > 0; o >>= 1) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
      t[k] += __shfl_xor_sync(0xffffffffu, t[k], o);
    }
  }
  const double u = (double)xc, v = (double)y;
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m0 = 0; m0 < kPoseTerms; m0 += tpp) {     // uniform across the warp
    const int m = m0 + lane;
    const int comp = m < 9 ? m / 3 : m - 9;
    const double sk = comp == 0 ? s[0] : comp == 1 ? s[1] : s[2];
    const double tk = comp == 0 ? t[0] : comp == 1 ? t[1] : t[2];
    const int which = m < 9 ? m % 3 : 3;
    double term = m >= kPoseTerms ? 0.0
                  : which == 0 ? sk * u : which == 1 ? sk * v : which == 2 ? sk : tk;
    for (int o = tpp; o < 32; o <<= 1) term += __shfl_xor_sync(0xffffffffu, term, o);
    if (wl < tpp && m < kPoseTerms) warp_terms[warp][m] = term;
  }
  __syncthreads();
  if (threadIdx.x < kPoseTerms) {
    double acc = 0.0;
#pragma unroll
    for (int q = 0; q < kPoseThreads / 32; ++q) acc += warp_terms[q][threadIdx.x];
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
__host__ inline int64_t pose_grad_blocks(int B, int D, int H, int W, int C, int kvec,
                                         int* tiles, int* groups) {
  const int tpp = C / kvec;
  if (C % kvec != 0 || tpp < 1 || tpp > 32 || (tpp & (tpp - 1)) != 0 || D < 1) return -1;
  if ((int64_t)H * W >= (1 << 27)) return -1;   // a tap offset and 4 flags in an int
  const int ppt = kPoseThreads / tpp;
  *tiles = (W + ppt - 1) / ppt;
  *groups = (D + kPosePlanes - 1) / kPosePlanes;
  return (int64_t)B * H * *tiles * *groups;
}

template <typename T>
cudaError_t launch_pose_grad(const void* dvol, const void* tgt, const float* depths,
                             const float* M, const float* Kt, double* partial, float* dM,
                             float* dKt, int B, int D, int H, int W, int C,
                             cudaStream_t stream) {
  int tiles = 0, groups = 0;
  const int64_t blocks = pose_grad_blocks(B, D, H, W, C, T::kVec, &tiles, &groups);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int tpp = C / T::kVec;   // the ring: min(tpp, 8) planes
  if (tpp == 1)
    plane_sweep_pose_grad_kernel<T, 1><<<(unsigned)blocks, kPoseThreads, 0, stream>>>(
        dvol, tgt, depths, M, Kt, partial, D, H, W, C, tiles, groups);
  else if (tpp == 2)
    plane_sweep_pose_grad_kernel<T, 2><<<(unsigned)blocks, kPoseThreads, 0, stream>>>(
        dvol, tgt, depths, M, Kt, partial, D, H, W, C, tiles, groups);
  else if (tpp == 4)
    plane_sweep_pose_grad_kernel<T, 4><<<(unsigned)blocks, kPoseThreads, 0, stream>>>(
        dvol, tgt, depths, M, Kt, partial, D, H, W, C, tiles, groups);
  else
    plane_sweep_pose_grad_kernel<T, 8><<<(unsigned)blocks, kPoseThreads, 0, stream>>>(
        dvol, tgt, depths, M, Kt, partial, D, H, W, C, tiles, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  plane_sweep_pose_grad_reduce<<<B, kPoseReduceThreads, 0, stream>>>(
      partial, dM, dKt, (int)(blocks / B));
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// DICL's displacement volume.

constexpr int kDispThreads = 256;
constexpr int kDispBlocksPerSm = 2;    // the store kernel's launch bound
constexpr int kDispMaxTileW = 1024;    // pixels a tile at most
constexpr int kDispPad = 8;            // shared-row elements left of a tile (>= md)
constexpr int kDispChunk = 8;          // channels a sampling task walks at once
constexpr int kDispMaxMd = 4;
constexpr int kDispMaxC = 64;
constexpr int kDispSmemMax = 200 * 1024;

// y's sample at batch item b's pixel q = (qx, qy), channel by channel:
// warped by B1's rule at q + (fx, fy) -- the flow there -- and rounded to T,
// or y itself without a flow. The forward and the backward both read y
// through it, so the backward's flags are the forward's bit for bit. The
// taps are computed once a pixel.
template <typename T>
struct DispSampler {
  int i00, i01, i10, i11;
  float wx, ax, wy, ay, valid;
  DispSampler() = default;
  __device__ __forceinline__ DispSampler(int qx, int qy, int h, int w) {   // no flow
    i00 = i01 = i10 = i11 = qy * w + qx;
    wx = ax = wy = ay = 0.f;
    valid = 1.f;
  }
  __device__ __forceinline__ DispSampler(int qx, int qy, float fx, float fy, int h, int w) {
    const Taps t(__fadd_rn((float)qx, fx), __fadd_rn((float)qy, fy), h, w);
    i00 = t.yi * w + t.xi;
    i01 = i00 + (t.xi1 - t.xi);
    i10 = i00 + (t.yi1 - t.yi) * w;
    i11 = i10 + (t.xi1 - t.xi);
    wx = t.wx; ax = t.ax; wy = t.wy; ay = t.ay; valid = t.valid;
  }
  __device__ __forceinline__ typename T::Bits bits(const char* yb, bool warped, int c,
                                                   int hw32) const {
    const int o = c * hw32;
    if (!warped) return T::load_bits(yb, o + i00);
    return T::from_float(blend(T::load1(yb, o + i00), T::load1(yb, o + i01),
                               T::load1(yb, o + i10), T::load1(yb, o + i11),
                               wx, ax, wy, ay, valid));
  }
  __device__ __forceinline__ float operator()(const char* yb, bool warped, int c,
                                              int hw32) const {
    return T::to_float(bits(yb, warped, c, hw32));
  }
  // channels ca .. cb - 1 (at most kDispChunk), their loads issued
  // together, each stored at dst[(c - ca) pitch]. True where one of them is
  // non-zero (a NaN counts: NaN != 0).
  __device__ __forceinline__ bool chunk(const char* yb, bool warped, int ca, int cb,
                                        typename T::Bits* dst, int pitch, int hw32) const {
    bool any = false;
#pragma unroll
    for (int k = 0; k < kDispChunk; ++k) {
      if (ca + k < cb) {
        const typename T::Bits v = bits(yb, warped, ca + k, hw32);
        dst[k * pitch] = v;
        any |= T::to_float(v) != 0.f;
      }
    }
    return any;
  }
};

// One thread's store unit: VB bytes (16, 8, 4, or one bf16 element) of
// consecutive pixels of one channel row, as 32-bit words (the low half of
// v[0] for a bf16 element).
template <int VB>
struct Chunk {
  static constexpr int kWords = VB >= 4 ? VB / 4 : 1;
  uint32_t v[kWords];
  __device__ __forceinline__ void load(const char* p) {
    if constexpr (VB == 16) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
      v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
    } else if constexpr (VB == 8) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = r.x; v[1] = r.y;
    } else if constexpr (VB == 4) {
      v[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      v[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }
  // a streaming store (st.global.cs): the stack is written once and read
  // by the next kernel, so it should not evict the maps the samples read
  __device__ __forceinline__ void store_cs(char* p) const {
    if constexpr (VB == 16) {
      __stcs(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
    } else if constexpr (VB == 8) {
      __stcs(reinterpret_cast<uint2*>(p), make_uint2(v[0], v[1]));
    } else if constexpr (VB == 4) {
      __stcs(reinterpret_cast<unsigned int*>(p), v[0]);
    } else {
      __stcs(reinterpret_cast<unsigned short*>(p), (unsigned short)v[0]);
    }
  }
};

// The VB bytes of a shared row from element e on (e of any alignment): the
// aligned words that hold them, funnel-shifted; bits beyond them are
// dropped.
template <typename T, int VB>
__device__ __forceinline__ Chunk<VB> row_window(const unsigned char* row, int e) {
  constexpr int kBytes = sizeof(typename T::Bits);
  Chunk<VB> out;
  if constexpr (VB == kBytes && kBytes == 2) {
    out.v[0] = reinterpret_cast<const unsigned short*>(row)[e];
  } else {
    const int byte = e * kBytes, sh = (byte & 3) * 8;
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(row) + (byte >> 2);
    if (sh == 0) {
#pragma unroll
      for (int i = 0; i < Chunk<VB>::kWords; ++i) out.v[i] = wp[i];
    } else {
#pragma unroll
      for (int i = 0; i < Chunk<VB>::kWords; ++i) out.v[i] = __funnelshift_r(wp[i], wp[i + 1], sh);
    }
  }
  return out;
}

// x m hole of a chunk where some pixel's flag is 0: that element times 0
// (-0 for a negative x, NaN for a NaN or infinite one, as the plain
// version's product gives); elements whose flag is 1 keep their bits.
template <typename T, int VB>
__device__ __forceinline__ Chunk<VB> times_keep(Chunk<VB> c, uint32_t keep) {
  constexpr int kBytes = sizeof(typename T::Bits), V = VB / kBytes;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if ((keep >> e) & 1u) continue;
    if constexpr (kBytes == 4) {
      c.v[e] = T::times_zero(c.v[e]);
    } else {
      const int wi = e >> 1, sh = (e & 1) * 16;
      const uint32_t old = (c.v[wi] >> sh) & 0xffffu;
      c.v[wi] = (c.v[wi] & ~(0xffffu << sh)) | (T::times_zero(old) << sh);
    }
  }
  return c;
}

// cp.async of VB bytes (4, 8 or 16) from global to shared memory; where
// `bytes` is 0 nothing is read and the VB bytes become zeros.
template <int VB>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
                 "n"(VB), "r"(bytes));
  }
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of the store kernel: two buffers of C x band_h rows of
// `pitch` elements (a tile and kDispPad elements each side, rounded up to
// 32 elements so each row's keep flags are whole words), then two buffers
// of band_h rows of `kwords` keep-flag words (pitch / 32 and a spare one,
// which a thread's funnel shift may read and drops).
struct DispSmem {
  int pitch, kwords, rows_bytes;
  __host__ __device__ DispSmem(int C, int band_h, int tile_w, int elem_bytes) {
    pitch = (tile_w + 2 * kDispPad + 31) / 32 * 32;
    kwords = pitch / 32 + 1;
    rows_bytes = C * band_h * pitch * elem_bytes;
  }
  __host__ __device__ int bytes(int band_h) const {
    return 2 * rows_bytes + 2 * band_h * kwords * 4;
  }
};

// ys into the centre displacement's y half: out[b, s0, C + c, q] = y's
// sample at q + flow(q) by B1's rule, rounded to T, s0 = md S + md (d = 0).
// That plane of the stack is ys itself (see displacement_volume_kernel), so
// the sample is stored once, where it belongs, and the store kernel reads it
// back from L2. A thread a pixel and 8 channels, pixels fastest (each
// channel's stores coalesce), 32 loads in flight.
template <typename T>
__global__ void __launch_bounds__(kDispThreads)
displacement_volume_sample(const void* __restrict__ y, const float* __restrict__ flow,
                           void* __restrict__ out, int B, int C, int h, int w, int md) {
  using Bits = typename T::Bits;
  const int S = 2 * md + 1, s0 = md * S + md;
  const int64_t hw = (int64_t)h * w;
  const int hw32 = h * w;
  const int chunks = (C + kDispChunk - 1) / kDispChunk;
  const int64_t total = (int64_t)B * chunks * hw;
  for (int64_t t = (int64_t)blockIdx.x * kDispThreads + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * kDispThreads) {
    const int q = (int)(t % hw);
    const int64_t rest = t / hw;
    const int ca = (int)(rest % chunks) * kDispChunk, b = (int)(rest / chunks);
    const int qx = q % w, qy = q / w;
    const float* f = flow + (int64_t)b * 2 * hw + q;
    const DispSampler<T> smp(qx, qy, __ldg(f), __ldg(f + hw), h, w);
    const char* yb = reinterpret_cast<const char*>(y) + (int64_t)b * C * hw * sizeof(Bits);
    Bits* const dst = reinterpret_cast<Bits*>(out) + ((int64_t)b * S * S + s0) * 2 * C * hw +
                      (int64_t)C * hw + q;
    smp.chunk(yb, true, ca, min(C, ca + kDispChunk), dst + (int64_t)ca * hw, hw32, hw32);
  }
}

// The stack from ys: x, ys (B, C, h, w) NCHW in T (ys: y itself without a
// flow, with one the centre displacement's y half that
// displacement_volume_sample wrote, at batch stride ys_bstride elements);
// out (B, S2, 2C, h, w), S = 2 md + 1, displacement s = (dv + md) S + du +
// md. The pair at (s, p) is [x(p) K(q) | ys(q)], q = p + (du, dv), ys(q) 0
// off the frame, K(q) 1 where q is in the frame and some channel of ys(q)
// is non-zero: x m hole and ys m hole of the plain version, bit for bit
// (ys m hole is ys itself in the frame: where hole is 0 every channel is
// +-0, and +-0 x 0 keeps its sign).
// An item (ops/cuda/sweep_warp.py::DisplacementPlan) is (b, dv, a band of
// band_h rows, a tile of tile_w pixels); item = ((b S + dv + md) bands +
// ty) tiles_x + tx. Its block
//   1. stages the ys rows py + dv of its band, every channel, the tile and
//      kDispPad elements each side, into shared memory by cp.async (zeros
//      off the frame), the next item's while it stores this one; or, with
//      `flow` (a plan that fuses the sampling: one item a block at the
//      coarse levels, where a second launch costs more than sampling a row
//      again for each dv), samples them itself from y;
//   2. computes the keep flags of those rows from shared memory: 8 lanes a
//      32-pixel word, each OR-ing the magnitude bits of C / 8 channels,
//      then OR-ed across the lanes by shuffles;
//   3. stores, for each channel and du, the band of both halves: a thread
//      a VB-byte chunk of a row and a channel at a time (units spread
//      evenly over the threads), neighbouring threads on neighbouring
//      chunks, so with whole-width tiles a warp writes 32 consecutive
//      chunks and a plane's band is one contiguous run; its x chunk loaded
//      once a unit (the next unit's ahead), its ys chunk of a du read from
//      shared memory at offset du (with 16-byte stores the three aligned
//      chunks around it once a unit and the windows shifted in registers,
//      du unrolled; else the funnel-shifted words of each window),
//      K by one funnel shift a thread and a shift a du; where K is 1 for
//      every pixel of the chunk the x chunk is stored as it is. With a
//      flow the centre's y half is already in place and not stored again.
template <typename T, int VB>
__global__ void __launch_bounds__(kDispThreads, kDispBlocksPerSm)
displacement_volume_kernel(const void* __restrict__ x, const void* __restrict__ ys,
                           int64_t ys_bstride, const float* __restrict__ flow,
                           void* __restrict__ out, int C, int h, int w, int md, int tile_w,
                           int tiles_x, int band_h, int bands, int skip_centre,
                           int64_t items) {
  using Bits = typename T::Bits;
  constexpr int kBytes = sizeof(Bits), V = VB / kBytes;
  constexpr uint32_t kFull = (1u << V) - 1u;
  extern __shared__ float4 disp_smem[];
  const int S = 2 * md + 1, s0 = md * S + md;
  const DispSmem lay(C, band_h, tile_w, kBytes);
  unsigned char* const rows_smem = reinterpret_cast<unsigned char*>(disp_smem);
  uint32_t* const flags = reinterpret_cast<uint32_t*>(rows_smem + 2 * lay.rows_bytes);
  const int64_t hw = (int64_t)h * w;
  const int tc = tile_w / V, positions = band_h * tc;     // store phase: (row, chunk)
  const int units = positions * C;                        // ... and channel
  const int staged_chunks = (tile_w + 2 * kDispPad) / V;   // chunks a staged row

  // the item's rows into buffer `buf`: chunk m of row i of channel c is
  // pixels x0 - kDispPad + m V .. of ys row y0 + i + dv
  auto stage = [&](int64_t item, int buf) {
    int64_t rem = item;
    const int tx = (int)(rem % tiles_x); rem /= tiles_x;
    const int ty = (int)(rem % bands); rem /= bands;
    const int dv = (int)(rem % S) - md, b = (int)(rem / S);
    const int x0 = tx * tile_w, y0 = ty * band_h;
    const char* src = reinterpret_cast<const char*>(ys) + b * ys_bstride * kBytes;
    unsigned char* const dst = rows_smem + buf * lay.rows_bytes;
    if (flow != nullptr) {   // sampled here: a task a pixel and 8 channels
      const int staged = tile_w + 2 * kDispPad, chunks = (C + kDispChunk - 1) / kDispChunk;
      const float* fb = flow + (int64_t)b * 2 * hw;
      for (int u = threadIdx.x; u < chunks * band_h * staged; u += kDispThreads) {
        const int ca = (u / (band_h * staged)) * kDispChunk, rest = u % (band_h * staged);
        const int i = rest / staged, m = rest - i * staged;
        const int r = y0 + i + dv, col = x0 - kDispPad + m;
        Bits* const d = reinterpret_cast<Bits*>(dst) + (ca * band_h + i) * lay.pitch + m;
        if (r >= 0 && r < h && col >= 0 && col < w) {
          const int q = r * w + col;
          const DispSampler<T> smp(col, r, __ldg(fb + q), __ldg(fb + hw + q), h, w);
          smp.chunk(src, true, ca, min(C, ca + kDispChunk), d, band_h * lay.pitch, (int)hw);
        } else {
          for (int c = ca; c < min(C, ca + kDispChunk); ++c)
            d[(c - ca) * band_h * lay.pitch] = Bits(0);
        }
      }
      return;
    }
    const int per_channel = band_h * staged_chunks;
    for (int u = threadIdx.x; u < C * per_channel; u += kDispThreads) {
      const int c = u / per_channel, rest = u - c * per_channel;
      const int i = rest / staged_chunks, m = rest - i * staged_chunks;
      const int r = y0 + i + dv, col = x0 - kDispPad + m * V;
      const bool in = r >= 0 && r < h && col >= 0 && col < w;
      unsigned char* const d = dst + ((c * band_h + i) * lay.pitch + m * V) * kBytes;
      const char* s = src + (in ? (c * hw + (int64_t)r * w + col) * kBytes : 0);
      if constexpr (VB >= 4) {
        copy_async<VB>(d, s, in ? VB : 0);
      } else {
        *reinterpret_cast<Bits*>(d) = in ? *reinterpret_cast<const Bits*>(s) : Bits(0);
      }
    }
    copy_async_commit();
  };

  int64_t item = blockIdx.x;
  if (item < items) stage(item, 0);
  for (int k = 0; item < items; item += gridDim.x, ++k) {
    const int buf = k & 1;
    copy_async_wait_all();
    __syncthreads();   // this item's rows are in; every thread is past the last item's stores
    if (item + gridDim.x < items) stage(item + gridDim.x, buf ^ 1);

    int64_t rem = item;
    const int tx = (int)(rem % tiles_x); rem /= tiles_x;
    const int ty = (int)(rem % bands); rem /= bands;
    const int dvi = (int)(rem % S), b = (int)(rem / S);
    const int x0 = tx * tile_w, y0 = ty * band_h, tw = min(tile_w, w - x0);
    const unsigned char* const rows = rows_smem + buf * lay.rows_bytes;
    uint32_t* const keep = flags + buf * band_h * lay.kwords;

    // 2. the keep flags: word wd of row i is staged elements 32 wd .. + 31
    const int words = lay.kwords - 1;
    for (int u = threadIdx.x; u < band_h * words * 8; u += kDispThreads) {
      const int lane8 = u & 7, wi = u >> 3;
      const int i = wi / words, wd = wi - i * words;
      constexpr int kWords = 32 * kBytes / 4;   // 32-bit words of 32 elements
      uint32_t acc[kWords];
#pragma unroll
      for (int m = 0; m < kWords; ++m) acc[m] = 0;
      for (int c = lane8; c < C; c += 8) {
        const uint4* p = reinterpret_cast<const uint4*>(
            rows + ((c * band_h + i) * lay.pitch + 32 * wd) * kBytes);
#pragma unroll
        for (int m = 0; m < kWords / 4; ++m) {
          const uint4 v = p[m];
          acc[4 * m] |= v.x; acc[4 * m + 1] |= v.y; acc[4 * m + 2] |= v.z; acc[4 * m + 3] |= v.w;
        }
      }
      uint32_t bits = 0;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if constexpr (kBytes == 2) {
          bits |= ((acc[e >> 1] >> (16 * (e & 1))) & 0x7fffu ? 1u : 0u) << e;
        } else {
          bits |= (acc[e] & 0x7fffffffu ? 1u : 0u) << e;
        }
      }
      // the 8 lanes of a word: lanes 8k .. 8k + 7 of a warp, all in the
      // loop or all out of it (the bound is a multiple of 8)
      const unsigned group = 0xffu << (threadIdx.x & 24);
      bits |= __shfl_xor_sync(group, bits, 1);
      bits |= __shfl_xor_sync(group, bits, 2);
      bits |= __shfl_xor_sync(group, bits, 4);
      if (lane8 == 0) keep[i * lay.kwords + wd] = bits;
    }
    __syncthreads();

    // 3. both halves of every channel, every du: unit u = c positions +
    //    (row, chunk), units t, t + kDispThreads, ... a thread, so every
    //    thread has the same number of units, give or take one
    const char* xb = reinterpret_cast<const char*>(x) + (int64_t)b * C * hw * kBytes;
    char* const ob = reinterpret_cast<char*>(out) + ((int64_t)b * S + dvi) * S * 2 * C * hw * kBytes;
    Chunk<VB> xv, xn;
    int u = threadIdx.x;
    const auto x_of = [&](int unit, Chunk<VB>& into) {
      const int c = unit / positions, pos = unit - c * positions;
      const int py = y0 + pos / tc, px = x0 + (pos % tc) * V;
      if (py < h && px < x0 + tw) into.load(xb + (c * hw + (int64_t)py * w + px) * kBytes);
    };
    if (u < units) x_of(u, xv);
    for (; u < units; u += kDispThreads) {
      if (u + kDispThreads < units) x_of(u + kDispThreads, xn);
      const int c = u / positions, pos = u - c * positions, pi = pos / tc, pj = pos % tc;
      const int py = y0 + pi, px = x0 + pj * V;
      if (py < h && pj * V < tw) {
        const int bit = kDispPad - md + pj * V;   // pixel px - md
        const uint32_t* krow = keep + pi * lay.kwords;
        const uint32_t kw = __funnelshift_r(krow[bit >> 5], krow[(bit >> 5) + 1], bit & 31);
        const unsigned char* yrow = rows + (c * band_h + pi) * lay.pitch * kBytes;
        char* const op = ob + ((int64_t)c * hw + (int64_t)py * w + px) * kBytes;
        const int64_t plane = (int64_t)2 * C * hw * kBytes, half = (int64_t)C * hw * kBytes;
        if constexpr (VB == 16) {
          // the three aligned chunks around the unit's, once (16-byte
          // loads, consecutive lanes on consecutive chunks: no bank
          // conflict); the window of du starts at element V + du of them
          uint32_t r[12];
          const uint4* cp =
              reinterpret_cast<const uint4*>(yrow) + pj + kDispPad / V - 1;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const uint4 v = cp[k];
            r[4 * k] = v.x; r[4 * k + 1] = v.y; r[4 * k + 2] = v.z; r[4 * k + 3] = v.w;
          }
#pragma unroll
          for (int du = -kDispMaxMd; du <= kDispMaxMd; ++du) {
            if (du < -md || du > md) continue;
            const uint32_t kdu = (kw >> (du + md)) & kFull;
            const int s = du + md;   // within the item's displacement row
            char* const o = op + s * plane;
            (kdu == kFull ? xv : times_keep<T, VB>(xv, kdu)).store_cs(o);
            if (skip_centre && dvi * S + s == s0) continue;
            Chunk<16> yv;
            if constexpr (kBytes == 4) {
#pragma unroll
              for (int k = 0; k < 4; ++k) yv.v[k] = r[V + du + k];
            } else {   // element e of r is half (e & 1) of word e >> 1
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int e = V + du + 2 * k;
                yv.v[k] = (e & 1) ? __funnelshift_r(r[e >> 1], r[(e >> 1) + 1], 16) : r[e >> 1];
              }
            }
            yv.store_cs(o + half);
          }
        } else {
          for (int du = -md; du <= md; ++du) {
            const uint32_t kdu = (kw >> (du + md)) & kFull;
            const int s = du + md;   // within the item's displacement row
            char* const o = op + s * plane;
            (kdu == kFull ? xv : times_keep<T, VB>(xv, kdu)).store_cs(o);
            if (!(skip_centre && dvi * S + s == s0))
              row_window<T, VB>(yrow, kDispPad + pj * V + du).store_cs(o + half);
          }
        }
      }
      xv = xn;
    }
  }
}

template <typename T, int VB>
cudaError_t launch_displacement_vb(const void* x, const void* ys, int64_t ys_bstride,
                                   const float* flow, void* out, int B, int C, int h, int w,
                                   int md, int tile_w, int band_h, int skip_centre, int grid,
                                   cudaStream_t stream) {
  const int S = 2 * md + 1;
  const int tiles_x = (w + tile_w - 1) / tile_w, bands = (h + band_h - 1) / band_h;
  const int64_t items = (int64_t)B * S * bands * tiles_x;
  const int smem = DispSmem(C, band_h, tile_w, (int)sizeof(typename T::Bits)).bytes(band_h);
  if (smem > kDispSmemMax) return cudaErrorInvalidValue;
  static bool opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {   // shared rows above 48 KB, once per device
    err = cudaFuncSetAttribute(displacement_volume_kernel<T, VB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDispSmemMax);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  displacement_volume_kernel<T, VB><<<(unsigned)grid, kDispThreads, smem, stream>>>(
      x, ys, ys_bstride, flow, out, C, h, w, md, tile_w, tiles_x, band_h, bands, skip_centre,
      items);
  return cudaGetLastError();
}

// One level: with a flow, displacement_volume_sample writes ys into the
// centre displacement's y half, and the store kernel reads it from there,
// or, where the plan fuses the sampling, the store kernel samples y itself;
// without a flow it reads y. The plan (ops/cuda/sweep_warp.py::
// displacement_plan) is checked here too: vec_bytes one of 16, 8, 4 or the
// element, dividing w's bytes and both addresses; tile_w a multiple of the
// pixels it moves, at most kDispMaxTileW; the shared memory within
// kDispSmemMax.
template <typename T>
cudaError_t launch_displacement(const void* x, const void* y, const float* flow, void* out,
                                int B, int C, int h, int w, int md, int vec_bytes, int tile_w,
                                int band_h, int fused, int grid, cudaStream_t stream) {
  constexpr int kBytes = sizeof(typename T::Bits);
  if (md < 0 || md > kDispMaxMd || C < 1 || C > kDispMaxC || B < 1 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  if ((vec_bytes != 16 && vec_bytes != 8 && vec_bytes != 4 && vec_bytes != kBytes) ||
      (w * kBytes) % vec_bytes != 0 || reinterpret_cast<uintptr_t>(x) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(y) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(out) % vec_bytes != 0)
    return cudaErrorInvalidValue;
  const int V = vec_bytes / kBytes;
  if (tile_w < V || tile_w % V != 0 || tile_w > kDispMaxTileW || band_h < 1 || grid < 1)
    return cudaErrorInvalidValue;
  const int S = 2 * md + 1;
  const int64_t hw = (int64_t)h * w;
  const void* ys = y;
  int64_t ys_bstride = (int64_t)C * hw;
  if (flow != nullptr && !fused) {
    const int64_t total = (int64_t)B * ((C + kDispChunk - 1) / kDispChunk) * hw;
    const int64_t blocks = (total + kDispThreads - 1) / kDispThreads;
    displacement_volume_sample<T><<<(unsigned)(blocks < 65535 ? blocks : 65535), kDispThreads,
                                    0, stream>>>(y, flow, out, B, C, h, w, md);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ys = reinterpret_cast<const char*>(out) + ((int64_t)(md * S + md) * 2 * C + C) * hw * kBytes;
    ys_bstride = (int64_t)S * S * 2 * C * hw;
  }
  const auto go = [&](auto vb) {
    return launch_displacement_vb<T, decltype(vb)::value>(
        x, ys, ys_bstride, fused ? flow : nullptr, out, B, C, h, w, md, tile_w, band_h,
        flow != nullptr && !fused, grid, stream);
  };
  if (vec_bytes == 16) return go(std::integral_constant<int, 16>{});
  if (vec_bytes == 8) return go(std::integral_constant<int, 8>{});
  if (vec_bytes == 4) return go(std::integral_constant<int, 4>{});
  if constexpr (kBytes == 2) return go(std::integral_constant<int, 2>{});
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// The displacement volume's backward.

constexpr int kDispBwdThreads = 256;
constexpr int kDispBwdWarps = kDispBwdThreads / 32;   // a block's channels, a warp each
constexpr int kDispBwdRows = 4;       // tile rows: a warp is 4 rows x 8 chunks of a channel
constexpr int kDispBwdChunks = 8;     // 16-byte chunks (T::kVec pixels) along a tile row
constexpr int kDispBwdWords = 4;      // 32-bit flag words a halo row (64 + 2 md <= 72 bits)
constexpr int kCastThreads = 256;

// 32 flags of a halo row from bit `bit` on (the row's words are padded by one)
__device__ __forceinline__ uint32_t flag_window(const uint32_t* row, int bit) {
  return __funnelshift_r(row[bit >> 5], row[(bit >> 5) + 1], bit & 31);
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_run(void* p, int64_t i, int col0, int w, const float* v) {
  constexpr int V = T::kVec;
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(reinterpret_cast<char*>(p) + i * (int64_t)sizeof(typename T::Bits)) =
        T::pack16(v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (col0 + j < w) T::store1(p, i + j, v[j]);
  }
}

// A block owns one batch item b, kDispBwdWarps channels (a warp each) and a
// tile of kDispBwdRows rows x TW = kDispBwdChunks V pixels; block = ((b
// cgroups + cg) tiles_y + ty) tiles_x + tx. Lane l of a warp owns row l / 8
// and the V-pixel run (chunk) l % 8 of its channel's tile: one 16-byte
// vector of dout per half and displacement.
// 1. Prologue: the flags of the tile plus an md halo, computed once per
//    block into shared memory as bits (a thread a pixel, shared atomic
//    ORs): bit set where the pixel is in the frame and some channel of y's
//    sample there is non-zero -- the forward's keep flag, by its code, for
//    finite y (an invalid sample is not flagged, which the forward does
//    where a tap is NaN or Inf). No separate launch, no hole array.
// 2. Sums, dv outer (a loop), du inner (unrolled: MD is a template
//    argument), in the forward's order of s:
//      dx[p]  += keep(p + d_s) ? dout[s, c, p] : 0
//      dyh[q] += dout[s, C + c, q - d_s] where q - d_s is in the frame
//    in float32. The x half is the lane's own aligned run; the y half is
//    the run shifted by -du, which lies in two aligned runs of row q_y -
//    dv: the lane's own column and its left (du > 0) or right (du < 0)
//    neighbour's (an L1 hit: the neighbouring lane loads it too), shifted
//    in registers by the compile-time du. A dv row's 3 S loads are issued
//    together before any is added (one block an SM, so up to 255
//    registers), so a lane waits on one memory latency a row, not one a
//    displacement. keep comes from one funnel shift of the flag bits
//    per dv and a bit test per (du, pixel): a select, not a branch. The
//    plain version multiplies by 0/1 masks and adds; adding +0 where it
//    adds a masked term or nothing gives the same bits (a sum that starts
//    at +0 never becomes -0), so dx is bit-identical to it.
// 3. dx is stored in T. dyh is multiplied by hole(q) (the plain version's
//    dyh * hole, bit for bit); without a flow that is dy, stored in T. With
//    one, each pixel's dyh goes to the four taps of its sample (`Taps`,
//    the forward's) times their bilinear weights, float32 atomics into acc,
//    in an order that varies from launch to launch; where neighbouring
//    pixels of a run share taps, their two terms are added in registers
//    first (left pixel's plus right pixel's); zero terms and invalid
//    samples add nothing.
// VEC: w % V == 0 and dout, dx, dy 16-byte aligned, so every run is one
// aligned vector; otherwise the same sums with scalar loads and stores.
template <typename T, int MD, bool VEC>
__global__ void __launch_bounds__(kDispBwdThreads, 1)
displacement_backward_kernel(const void* __restrict__ dout, const void* __restrict__ y,
                             const float* __restrict__ flow, void* __restrict__ dx,
                             void* __restrict__ dy, float* __restrict__ acc, int C, int h,
                             int w, int cgroups, int tiles_x, int tiles_y) {
  constexpr int S = 2 * MD + 1, V = T::kVec;
  constexpr int HR = kDispBwdRows + 2 * MD;          // halo rows
  constexpr int HWp = kDispBwdChunks * V + 2 * MD;   // halo row width in pixels
  static_assert(HWp + V <= 32 * (kDispBwdWords - 1), "flag words");
  __shared__ uint32_t flags[HR][kDispBwdWords];
  constexpr int kBytes = sizeof(typename T::Bits);

  int item = blockIdx.x;
  const int tx = item % tiles_x; item /= tiles_x;
  const int ty = item % tiles_y; item /= tiles_y;
  const int cg = item % cgroups;
  const int b = item / cgroups;
  const int x0 = tx * kDispBwdChunks * V, y0 = ty * kDispBwdRows;
  const int64_t hw = (int64_t)h * w;
  const char* yb = reinterpret_cast<const char*>(y) + (int64_t)b * C * hw * kBytes;
  const float* fb = flow == nullptr ? nullptr : flow + (int64_t)b * 2 * hw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = cg * kDispBwdWarps + warp;           // the warp's channel
  const int rr = lane / kDispBwdChunks, kk = lane % kDispBwdChunks;
  const int r = y0 + rr, col0 = x0 + kk * V;         // the lane's run
  const int64_t pair = 2 * (int64_t)C * hw;          // one displacement's elements
  const char* gb = reinterpret_cast<const char*>(dout) + (int64_t)b * S * S * pair * kBytes;

  // 1. the flags of the tile and its halo: hole(q), some channel of y's
  //    sample at q non-zero (the forward's keep flag), as bits set with
  //    shared atomic ORs, thread t taking halo pixels t, t + 256, ... Each
  //    thread fetches its pixels' flows together, then channel 0 of their
  //    samples together (addresses clamped into the frame, branch-free),
  //    and walks the other channels only where that one is zero and the
  //    sample is valid (for finite y an invalid one is zero).
  constexpr int R = (HR * HWp + kDispBwdThreads - 1) / kDispBwdThreads;
  uint32_t* const fw = &flags[0][0];
  for (int u = threadIdx.x; u < HR * kDispBwdWords; u += kDispBwdThreads) fw[u] = 0u;
  const int hw32 = h * w;
  const bool warped = fb != nullptr;
  int qxs[R], qys[R];
  DispSampler<T> smp[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int u = threadIdx.x + i * kDispBwdThreads;
    qxs[i] = min(max(x0 - MD + u % HWp, 0), w - 1);
    qys[i] = min(max(y0 - MD + min(u / HWp, HR - 1), 0), h - 1);
    smp[i] = DispSampler<T>(qxs[i], qys[i], h, w);
  }
  if (warped) {
    float fx[R], fy[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      fx[i] = __ldg(fb + qys[i] * w + qxs[i]);
      fy[i] = __ldg(fb + hw32 + qys[i] * w + qxs[i]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) smp[i] = DispSampler<T>(qxs[i], qys[i], fx[i], fy[i], h, w);
  }
  float first[R];
#pragma unroll
  for (int i = 0; i < R; ++i) first[i] = smp[i](yb, warped, 0, hw32);
  __syncthreads();                                   // the words are zeroed
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int u = threadIdx.x + i * kDispBwdThreads, hr = u / HWp, hc = u % HWp;
    const int qy = y0 - MD + hr, qx = x0 - MD + hc;
    const bool in = u < HR * HWp && qy >= 0 && qy < h && qx >= 0 && qx < w;
    // an invalid sample is zero in every channel for finite y (blend
    // multiplies by its validity, 0), so only a valid one walks the
    // channels, four at a time. Where y holds NaN or Inf on a tap of an
    // invalid sample, the forward's blend is NaN there and keeps the
    // sample; this flag does not (finite y is the backward's precondition,
    // as `displacement_volume_backward_plain` states)
    bool keep = in && smp[i].valid != 0.f && first[i] != 0.f;
    for (int ch = 1; in && smp[i].valid != 0.f && !keep && ch < C; ch += 4) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = smp[i](yb, warped, min(ch + k, C - 1), hw32);
#pragma unroll
      for (int k = 0; k < 4; ++k) keep |= v[k] != 0.f;
    }
    if (keep) atomicOr(&flags[hr][hc >> 5], 1u << (hc & 31));
  }
  __syncthreads();

  // 2. the sums of the lane's run
  if (c >= C || r >= h || col0 >= w) return;
  const int64_t xo = (int64_t)c * hw + (int64_t)r * w + col0;   // the run's x-half element
  float sx[V], sy[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sx[j] = sy[j] = 0.f;

#pragma unroll 1
  for (int dvi = 0; dvi < S; ++dvi) {
    // bit i: the flag of halo column kk V + i of row r + dv, i.e. of
    // q = p + (du, dv) for pixel j of the run at i = j + du + MD
    const uint32_t fbits = flag_window(flags[rr + dvi], kk * V);
    if constexpr (VEC) {
      // a displacement row at once: all its loads (the x half's S runs, the
      // y half's S own and S neighbour runs; addresses clamped into the
      // frame, so the loads are unconditional and the masks are selects)
      // before any add
      const int ry = r - (dvi - MD);                 // the y half's source row q_y - dv
      const bool yrow = ry >= 0 && ry < h;
      const int64_t yo = (int64_t)(C + c) * hw + (int64_t)(yrow ? ry : 0) * w;
      const char* gv = gb + (int64_t)dvi * S * pair * kBytes;
      uint4 xr[S];
#pragma unroll
      for (int dui = 0; dui < S; ++dui)
        xr[dui] = __ldcs(reinterpret_cast<const uint4*>(gv + ((int64_t)dui * pair + xo) * kBytes));
      // the y half: dout[s, C + c, ry, col0 + j - du] lies in the own run
      // and the left (du > 0) or right (du < 0) one
      uint4 own[S], nb[S];
#pragma unroll
      for (int dui = 0; dui < S; ++dui) {
        const int du = dui - MD;
        const char* g = gv + (int64_t)dui * pair * kBytes;
        const int ncol = min(max(du > 0 ? col0 - V : col0 + V, 0), w - V);
        own[dui] = __ldg(reinterpret_cast<const uint4*>(g + (yo + col0) * kBytes));
        nb[dui] = __ldg(reinterpret_cast<const uint4*>(g + (yo + ncol) * kBytes));
      }
#pragma unroll
      for (int dui = 0; dui < S; ++dui) {
        float v[V];
        T::unpack16(xr[dui], v);
#pragma unroll
        for (int j = 0; j < V; ++j)
          sx[j] = __fadd_rn(sx[j], (fbits >> (dui + j)) & 1u ? v[j] : 0.f);
      }
#pragma unroll
      for (int dui = 0; dui < S; ++dui) {
        const int du = dui - MD;
        const bool nok = yrow && (du > 0 ? col0 - V >= 0 : col0 + V < w);
        float ov[V], nv[V];
        T::unpack16(own[dui], ov);
        T::unpack16(nb[dui], nv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int k = j - du;                        // index into the own run
          float v;
          bool ok;
          if (k < 0) { v = nv[V + k]; ok = nok; }
          else if (k >= V) { v = nv[k - V]; ok = nok; }
          else { v = ov[k]; ok = yrow; }
          sy[j] = __fadd_rn(sy[j], ok ? v : 0.f);
        }
      }
    } else {
      // without vectors: a displacement row in two phases, each of which
      // issues all its loads before it adds any (the x half's S V elements,
      // then the y half's); every address is clamped into the frame, so the
      // loads are unconditional and the masks are selects
      const int ry = r - (dvi - MD);                 // the y half's source row q_y - dv
      const bool yrow = ry >= 0 && ry < h;
      const int64_t yo = (int64_t)(C + c) * hw + (int64_t)(yrow ? ry : 0) * w;
      const char* gv = gb + (int64_t)dvi * S * pair * kBytes;
      float xv[S][V];
#pragma unroll
      for (int dui = 0; dui < S; ++dui)
#pragma unroll
        for (int j = 0; j < V; ++j)
          xv[dui][j] = T::load1(gv + (int64_t)dui * pair * kBytes, xo + min(j, w - 1 - col0));
#pragma unroll
      for (int dui = 0; dui < S; ++dui)
#pragma unroll
        for (int j = 0; j < V; ++j)
          sx[j] = __fadd_rn(sx[j], (fbits >> (dui + j)) & 1u ? xv[dui][j] : 0.f);
      float yv[S][V];
#pragma unroll
      for (int dui = 0; dui < S; ++dui)
#pragma unroll
        for (int j = 0; j < V; ++j)
          yv[dui][j] = T::load1(gv + (int64_t)dui * pair * kBytes,
                                yo + min(max(col0 + j - (dui - MD), 0), w - 1));
#pragma unroll
      for (int dui = 0; dui < S; ++dui)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int col = col0 + j - (dui - MD);
          sy[j] = __fadd_rn(sy[j], yrow && col >= 0 && col < w ? yv[dui][j] : 0.f);
        }
    }
  }

  // 3. dx; dyh * hole(q); dy, or its scatter onto the taps
  const int64_t out = (int64_t)b * C * hw + xo;
  store_run<T, VEC>(dx, out, col0, w, sx);
  const uint32_t hole = flag_window(flags[rr + MD], kk * V + MD);   // bit j: hole of pixel j
#pragma unroll
  for (int j = 0; j < V; ++j) sy[j] = __fmul_rn(sy[j], (hole >> j) & 1u ? 1.f : 0.f);
  if (fb == nullptr) {
    store_run<T, VEC>(dy, out, col0, w, sy);
    return;
  }
  float* a = acc + ((int64_t)b * C + c) * hw;
  // Neighbouring pixels of a run whose samples share their taps (the left
  // pixel's right taps are the right pixel's left taps, as where the flow
  // is smooth) add those two terms in registers first, the left pixel's
  // plus the right pixel's, and then atomically: 18 atomics for 8 such
  // pixels, not 32. `pt`, `pb`: the pending right taps (top, bottom).
  int64_t pt = -1, pb = -1;
  float vt = 0.f, vb = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int px = col0 + j;
    if (px >= w || sy[j] == 0.f) continue;
    const int q = r * w + px;
    const Taps t(__fadd_rn((float)px, __ldg(fb + q)), __fadd_rn((float)r, __ldg(fb + hw32 + q)),
                 h, w);
    if (t.valid == 0.f) continue;
    float t00 = __fmul_rn(sy[j], __fmul_rn(t.ay, t.ax));
    float t10 = __fmul_rn(sy[j], __fmul_rn(t.wy, t.ax));
    if (pt == t.i00 && pb == t.i10) {
      t00 = __fadd_rn(vt, t00);
      t10 = __fadd_rn(vb, t10);
    } else if (pt >= 0) {
      atomicAdd(a + pt, vt);
      atomicAdd(a + pb, vb);
    }
    atomicAdd(a + t.i00, t00);
    atomicAdd(a + t.i10, t10);
    pt = t.i01;
    pb = t.i11;
    vt = __fmul_rn(sy[j], __fmul_rn(t.ay, t.wx));
    vb = __fmul_rn(sy[j], __fmul_rn(t.wy, t.wx));
  }
  if (pt >= 0) {
    atomicAdd(a + pt, vt);
    atomicAdd(a + pb, vb);
  }
}

// out[i] = in[i] rounded to T, four elements a thread where n % 4 == 0
template <typename T>
__global__ void __launch_bounds__(kCastThreads)
cast_f32_kernel(const float* __restrict__ in, void* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kCastThreads;
  if (n % 4 == 0) {
    for (int64_t i = (int64_t)blockIdx.x * kCastThreads + threadIdx.x; i < n / 4; i += stride) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(in) + i);
      T::store1(out, 4 * i, v.x);
      T::store1(out, 4 * i + 1, v.y);
      T::store1(out, 4 * i + 2, v.z);
      T::store1(out, 4 * i + 3, v.w);
    }
  } else {
    for (int64_t i = (int64_t)blockIdx.x * kCastThreads + threadIdx.x; i < n; i += stride)
      T::store1(out, i, in[i]);
  }
}

template <typename T, int MD>
cudaError_t launch_disp_bwd_md(bool vec, unsigned blocks, const void* dout, const void* y,
                               const float* flow, void* dx, void* dy, float* acc, int C, int h,
                               int w, int cgroups, int tiles_x, int tiles_y,
                               cudaStream_t stream) {
  if (vec)
    displacement_backward_kernel<T, MD, true><<<blocks, kDispBwdThreads, 0, stream>>>(
        dout, y, flow, dx, dy, acc, C, h, w, cgroups, tiles_x, tiles_y);
  else
    displacement_backward_kernel<T, MD, false><<<blocks, kDispBwdThreads, 0, stream>>>(
        dout, y, flow, dx, dy, acc, C, h, w, cgroups, tiles_x, tiles_y);
  return cudaGetLastError();
}

// With a flow: acc zeroed (a memset), the backward, and where dy is not acc
// itself (T is bfloat16) the cast of acc into dy: three launches, two in
// float32; without one, the backward alone.
template <typename T>
cudaError_t launch_displacement_backward(const void* dout, const void* y, const float* flow,
                                         void* dx, void* dy, float* acc, int B, int C, int h,
                                         int w, int md, cudaStream_t stream) {
  if (md < 0 || md > kDispMaxMd || C < 1 || C > kDispMaxC) return cudaErrorInvalidValue;
  constexpr int V = T::kVec;
  const int tiles_x = (w + kDispBwdChunks * V - 1) / (kDispBwdChunks * V);
  const int tiles_y = (h + kDispBwdRows - 1) / kDispBwdRows;
  const int cgroups = (C + kDispBwdWarps - 1) / kDispBwdWarps;
  const int64_t blocks = (int64_t)B * cgroups * tiles_y * tiles_x;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int64_t n = (int64_t)B * C * h * w;
  cudaError_t err;
  if (flow != nullptr) {
    err = cudaMemsetAsync(acc, 0, n * sizeof(float), stream);
    if (err != cudaSuccess) return err;
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dx) |
                          (flow == nullptr ? reinterpret_cast<uintptr_t>(dy) : 0);
  const bool vec = w % V == 0 && (align & 15) == 0;
  const unsigned grid = (unsigned)blocks;
  switch (md) {
    case 0: err = launch_disp_bwd_md<T, 0>(vec, grid, dout, y, flow, dx, dy, acc, C, h, w, cgroups, tiles_x, tiles_y, stream); break;
    case 1: err = launch_disp_bwd_md<T, 1>(vec, grid, dout, y, flow, dx, dy, acc, C, h, w, cgroups, tiles_x, tiles_y, stream); break;
    case 2: err = launch_disp_bwd_md<T, 2>(vec, grid, dout, y, flow, dx, dy, acc, C, h, w, cgroups, tiles_x, tiles_y, stream); break;
    case 3: err = launch_disp_bwd_md<T, 3>(vec, grid, dout, y, flow, dx, dy, acc, C, h, w, cgroups, tiles_x, tiles_y, stream); break;
    default: err = launch_disp_bwd_md<T, 4>(vec, grid, dout, y, flow, dx, dy, acc, C, h, w, cgroups, tiles_x, tiles_y, stream); break;
  }
  if (err != cudaSuccess || flow == nullptr || dy == acc) return err;
  const int64_t cast_blocks = (n / 4 + kCastThreads - 1) / kCastThreads;
  const unsigned cast_grid = (unsigned)(cast_blocks < 1 ? 1 : (cast_blocks < 1024 ? cast_blocks : 1024));
  cast_f32_kernel<T><<<cast_grid, kCastThreads, 0, stream>>>(acc, dy, n);
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

// The rows of the pose gradient's partials (12 doubles each) for B, D, H,
// W, C of `dtype`, or -1 where the kernel does not take C.
extern "C" long long dsfm_plane_sweep_volume_pose_grad_blocks(int B, int D, int H, int W,
                                                              int C, int dtype) {
  int tiles = 0, groups = 0;
  if (dtype != 0 && dtype != 1) return -1;
  return pose_grad_blocks(B, D, H, W, C, dtype == 0 ? F32::kVec : BF16::kVec, &tiles, &groups);
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

// DICL's displacement volume: out (B, S2, 2C, h, w), S = 2 md + 1, of x and
// y (B, C, h, w) of `dtype` (0 = float32, 1 = bfloat16), NCHW, warped by
// flow (B, 2, h, w) float32 on the device, or not warped where flow is
// null, under the work mapping vec_bytes, tile_w, band_h, fused, grid
// (ops/cuda/sweep_warp.py::displacement_plan; launch_displacement says what
// it refuses). The wrapper checks 0 <= md <= 4, 1 <= C <= 64, B, h, w >= 1
// and h w < 2^24 (offsets inside one channel fit an int).
extern "C" int dsfm_displacement_volume(const void* x, const void* y, const void* flow,
                                        void* out, int B, int C, int h, int w, int md,
                                        int dtype, int vec_bytes, int tile_w, int band_h,
                                        int fused, int grid, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* fp = reinterpret_cast<const float*>(flow);
  if (dtype == 0)
    return launch_displacement<F32>(x, y, fp, out, B, C, h, w, md, vec_bytes, tile_w, band_h,
                                     fused, grid, s);
  if (dtype == 1)
    return launch_displacement<BF16>(x, y, fp, out, B, C, h, w, md, vec_bytes, tile_w,
                                      band_h, fused, grid, s);
  return (int)cudaErrorInvalidValue;
}

// The displacement volume's backward: given dout (B, S2, 2C, h, w) of
// `dtype`, y (B, C, h, w) of `dtype` and flow (B, 2, h, w) float32 or null,
// as the forward took them, writes dx (B, C, h, w) of `dtype` and dy
// (B, C, h, w) of `dtype`. With a flow, dy is summed in acc (B, C, h, w)
// float32, which the launch zeroes itself, then cast into dy; in float32 dy
// may be acc itself, and then there is no cast. Without a flow acc is not
// read. The same rules as the forward.
extern "C" int dsfm_displacement_volume_backward(const void* dout, const void* y,
                                                 const void* flow, void* dx, void* dy,
                                                 void* acc, int B, int C, int h, int w, int md,
                                                 int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* fp = reinterpret_cast<const float*>(flow);
  float* ap = reinterpret_cast<float*>(acc);
  if (dtype == 0)
    return launch_displacement_backward<F32>(dout, y, fp, dx, dy, ap, B, C, h, w, md, s);
  if (dtype == 1)
    return launch_displacement_backward<BF16>(dout, y, fp, dx, dy, ap, B, C, h, w, md, s);
  return (int)cudaErrorInvalidValue;
}
