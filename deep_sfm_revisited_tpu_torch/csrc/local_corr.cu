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
// PWC-DC launches it at level 6 only; levels 5..2 warp f2 by the flow
// first and run the warped correlation (warped_corr.cu) in the network's
// NCHW layout and dtype.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Start the copies of channels [cb, cb + kChunk) of the f1 halo and the f0
// tile into one stage; channels at or past cend, and pixels off the frame,
// are zero-filled. Rows 0..HaloH-1 are the halo, the next kTileH the f0 tile.
template <int MD, int PX>
__device__ __forceinline__ void stage(float4* buf, const float* f0, const float* f1,
                                      int64_t img, int H, int W, int C, int y0, int x0,
                                      int cb, int cend, bool vec, int warp, int lane) {
  using G = Geometry<MD, PX>;
  for (int r = warp; r < G::HaloH + kTileH; r += G::S) {
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

template <int MD, int PX>
__global__ void __launch_bounds__(Geometry<MD, PX>::Threads)
local_corr_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                  float* __restrict__ out, int H, int W, int C, int cluster_size, int vec) {
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

  // ring of kStages stages: chunk k lives in stage k % kStages; one commit
  // group per chunk (possibly empty), so waiting until kStages - 1 groups
  // are pending means chunk k has landed
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nk)
      stage<MD, PX>(smem + k * G::StageF4, f0, f1, img, H, W, C, y0, x0, cbeg + k * kChunk,
                    cend, vec, dyr, lane);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    const int next = k + kStages - 1;
    if (next < nk)
      stage<MD, PX>(smem + (next % kStages) * G::StageF4, f0, f1, img, H, W, C, y0, x0,
                    cbeg + next * kChunk, cend, vec, dyr, lane);
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

template <int MD, int PX>
cudaError_t launch(const float* f0, const float* f1, float* out, int B, int H, int W, int C,
                   int cluster_size, cudaStream_t stream) {
  using G = Geometry<MD, PX>;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(local_corr_kernel<MD, PX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, G::SmemBytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int tiles_x = (W + G::TileW - 1) / G::TileW, tiles_y = (H + kTileH - 1) / kTileH;
  if (tiles_y > 65535 || B > 65535) return cudaErrorInvalidConfiguration;
  const bool aligned = ((reinterpret_cast<uintptr_t>(f0) | reinterpret_cast<uintptr_t>(f1)) & 15) == 0;
  const int vec = (C % 4 == 0 && aligned) ? 1 : 0;

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
  err = cudaLaunchKernelEx(&cfg, local_corr_kernel<MD, PX>, f0, f1, out, H, W, C,
                           cluster_size, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MD>
cudaError_t launch_px(const float* f0, const float* f1, float* out, int B, int H, int W,
                      int C, int px, int cluster_size, cudaStream_t stream) {
  switch (px) {
    case 1: return launch<MD, 1>(f0, f1, out, B, H, W, C, cluster_size, stream);
    case 2: return launch<MD, 2>(f0, f1, out, B, H, W, C, cluster_size, stream);
    case 4: return launch<MD, 4>(f0, f1, out, B, H, W, C, cluster_size, stream);
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
  if (cluster < 1 || cluster > kMaxCluster || cluster > (C + 3) / 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* a = reinterpret_cast<const float*>(f0);
  const float* b = reinterpret_cast<const float*>(f1);
  float* o = reinterpret_cast<float*>(out);
  switch (md) {
    case 1: return launch_px<1>(a, b, o, B, H, W, C, px, cluster, s);
    case 2: return launch_px<2>(a, b, o, B, H, W, C, px, cluster, s);
    case 3: return launch_px<3>(a, b, o, B, H, W, C, px, cluster, s);
    case 4: return launch_px<4>(a, b, o, B, H, W, C, px, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
