// Kernel B2's entry points as PyTorch operators (namespace `dsfm_corr`):
// the windowed correlation (local_corr.cu) and the warped correlation that
// PWC-DC's levels 5..2 launch (warped_corr.cu), in PWC-DC's NCHW layout and
// dtype, and their backward kernels (warped_corr_backward.cu), which
// ops/correlation.py's autograd functions launch.
//
// As for B1 (sweep_warp_ops.cpp, which says why): each launch is one
// dispatcher call from Python, with the checks, the allocation, the device
// guard, the current stream (the capture stream inside `torch.cuda.graph`)
// and the launch in C++, and nothing synchronises, so PWC-DC's flow stage
// can be captured in a CUDA graph. The work mappings come from
// ops/cuda/local_corr.py::plan, ::warped_plan and ::backward_plan, which the
// CPU tests replay.
//
// Host code only: it calls the plain C launchers of local_corr.cu,
// warped_corr.cu and warped_corr_backward.cu, whose libraries it links. ops/cuda/local_corr.py builds it with nvcc against
// torch.utils.cpp_extension's include and library paths and loads it with
// torch.ops.load_library.

#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <algorithm>
#include <cstdint>
#include <tuple>
#include <utility>

extern "C" {
int dsfm_local_correlation(const void* f0, const void* f1, void* out, int B, int H, int W, int C,
                           int md, int px, int cluster, void* stream);
int dsfm_warped_correlation(const void* f1, const void* f2, const void* flow, int flow_dtype,
                            int fs_b, int fs_k, int fs_y, int fs_x, float scale, void* out, int B,
                            int H, int W, int C, int md, int px, int cluster, int dtype,
                            void* stream);
int dsfm_local_correlation_backward(const void* f0, const void* f1, const void* dout, void* df0,
                                    void* df1, int B, int H, int W, int C, int md, int tile_h,
                                    int tile_w, int run, int slots, void* stream);
int dsfm_warped_correlation_backward(const void* f1, const void* f2, const void* flow,
                                     int flow_dtype, int fs_b, int fs_k, int fs_y, int fs_x,
                                     float scale, const void* dout, long long dout_sb,
                                     long long dout_ld, void* df1, void* df2, float* acc,
                                     void* dflow, int ds_b, int ds_k, int ds_y, int ds_x, int B,
                                     int H, int W, int C, int md, int dtype, int tile_h,
                                     int tile_w, int run, int slots, void* stream);
}

namespace {

constexpr int64_t kMaxMd = 4, kMaxCluster = 8;
// the backward kernels' mapping (warped_corr_backward.cu: kSlot, kMaxThreads)
constexpr int64_t kSlot = 8, kMaxBackwardThreads = 512;

void* current_stream(const at::Device& device) {
  return c10::impl::getDeviceGuardImpl(device.type())->getStream(device).native_handle();
}

// non-negative strides whose last element lies under 2^31 (the kernels'
// 32-bit element offsets)
void check_strides(const char* what, const char* name, const at::Tensor& t) {
  int64_t reach = 0;
  for (int d = 0; d < t.dim(); ++d) reach += (t.size(d) - 1) * t.stride(d);
  TORCH_CHECK_VALUE(t.storage_offset() >= 0 && reach < (int64_t(1) << 31) &&
                        *std::min_element(t.strides().begin(), t.strides().end()) >= 0,
                    what, " ", name, " strides ", t.strides(), " out of range");
}

// a (B, H, W, C) float32 feature map on `device`, contiguous, of `shape`
void check_features(const char* what, const char* name, const at::Tensor& t,
                    const at::Device& device, at::IntArrayRef shape) {
  TORCH_CHECK_VALUE(t.is_cuda() && t.device() == device, what, " takes CUDA tensors on one "
                    "device; ", name, " on ", t.device());
  TORCH_CHECK_TYPE(t.scalar_type() == at::kFloat, what, " ", name, " dtype ", t.scalar_type(),
                   "; takes float32");
  TORCH_CHECK_VALUE(t.dim() == 4 && t.sizes() == shape, what, " ", name, " ", t.sizes(),
                    "; takes ", shape);
  TORCH_CHECK_VALUE(t.is_contiguous(), what, " takes contiguous NHWC features");
}

// the correlation's rules: (B, H, W, C) all >= 1, H W < 2^31; md, px,
// cluster as ops/cuda/local_corr.py::plan gives them
void check_shape(const char* what, const at::Tensor& f, int64_t md, int64_t px,
                 int64_t cluster) {
  TORCH_CHECK_VALUE(f.dim() == 4 && f.size(0) >= 1 && f.size(1) >= 1 && f.size(2) >= 1 &&
                        f.size(3) >= 1 && f.size(1) * f.size(2) < (int64_t(1) << 31),
                    what, " feature shape ", f.sizes(), " out of range");
  TORCH_CHECK_VALUE(md >= 1 && md <= kMaxMd, what, " max displacement ", md, "; takes 1..",
                    kMaxMd);
  TORCH_CHECK_VALUE(px == 1 || px == 2 || px == 4, what, " px ", px, "; takes 1, 2 or 4");
  TORCH_CHECK_VALUE(cluster >= 1 && cluster <= kMaxCluster && cluster <= (f.size(3) + 3) / 4,
                    what, " cluster ", cluster, " for C = ", f.size(3));
}

// f0, f1 (B, H, W, C) float32 -> (B, H, W, (2md+1)^2) float32
at::Tensor local_correlation(const at::Tensor& f0, const at::Tensor& f1, int64_t md, int64_t px,
                             int64_t cluster) {
  const char* what = "B2";
  TORCH_CHECK_VALUE(f0.is_cuda(), what, " takes CUDA tensors only");
  check_features(what, "f0", f0, f0.device(), f0.sizes());
  check_features(what, "f1", f1, f0.device(), f0.sizes());
  check_shape(what, f0, md, px, cluster);
  const int64_t B = f0.size(0), H = f0.size(1), W = f0.size(2), C = f0.size(3);
  c10::OptionalDeviceGuard guard(f0.device());
  at::Tensor out = at::empty({B, H, W, (2 * md + 1) * (2 * md + 1)}, f0.options());
  const int err = dsfm_local_correlation(f0.data_ptr(), f1.data_ptr(), out.data_ptr(), B, H, W,
                                         C, md, px, cluster, current_stream(f0.device()));
  TORCH_CHECK(err == 0, what, " launch failed: cudaError ", err);
  return out;
}

// The warped correlation's rules, for its forward and backward: f1, f2
// (B, C, H, W) of one dtype, float32 or bfloat16, channels-last contiguous,
// every size >= 1, C H W < 2^31; flow (B, 2, H, W) float32 or bfloat16, any
// non-negative strides reaching under 2^31; md in 1..kMaxMd.
void check_warped(const char* what, const at::Tensor& f1, const at::Tensor& f2,
                  const at::Tensor& flow, int64_t md) {
  TORCH_CHECK_VALUE(f1.is_cuda(), what, " takes CUDA tensors only");
  const at::Device device = f1.device();
  for (const auto& [name, t] : {std::pair<const char*, const at::Tensor&>{"f1", f1},
                                {"f2", f2}, {"flow", flow}}) {
    TORCH_CHECK_VALUE(t.is_cuda() && t.device() == device, what, " takes CUDA tensors on one "
                      "device; ", name, " on ", t.device());
    TORCH_CHECK_TYPE(t.scalar_type() == at::kFloat || t.scalar_type() == at::kBFloat16, what,
                     " ", name, " dtype ", t.scalar_type(), "; takes float32 or bfloat16");
    TORCH_CHECK_VALUE(t.dim() == 4, what, " takes 4-d ", name, "; got ", t.sizes());
  }
  for (const auto& [name, t] : {std::pair<const char*, const at::Tensor&>{"f1", f1},
                                {"f2", f2}}) {
    TORCH_CHECK_VALUE(t.is_contiguous(at::MemoryFormat::ChannelsLast), what,
                      " takes channels-last contiguous ", name, "; got strides ", t.strides());
  }
  TORCH_CHECK_TYPE(f2.scalar_type() == f1.scalar_type(), what, " f1 ", f1.scalar_type(),
                   ", f2 ", f2.scalar_type(), "; takes one dtype");
  TORCH_CHECK_VALUE(f2.sizes() == f1.sizes(), what, " f2 ", f2.sizes(), "; takes ", f1.sizes());
  const int64_t B = f1.size(0), C = f1.size(1), H = f1.size(2), W = f1.size(3);
  TORCH_CHECK_VALUE(B >= 1 && C >= 1 && H >= 1 && W >= 1 && C * H * W < (int64_t(1) << 31),
                    what, " feature shape ", f1.sizes(), " out of range");
  TORCH_CHECK_VALUE(flow.size(0) == B && flow.size(1) == 2 && flow.size(2) == H &&
                        flow.size(3) == W,
                    what, " flow ", flow.sizes(), "; takes (", B, ", 2, ", H, ", ", W, ")");
  check_strides(what, "flow", flow);
  TORCH_CHECK_VALUE(md >= 1 && md <= kMaxMd, what, " max displacement ", md, "; takes 1..",
                    kMaxMd);
}

// f1, f2 (B, C, H, W) of one dtype, float32 or bfloat16, channels-last
// contiguous; flow (B, 2, H, W) float32 or bfloat16, any strides; the
// flow's scale -> (B, (2md+1)^2, H, W) of f1's dtype, channels-last: the
// correlation of f1 with f2 sampled at q + scale flow(q); px and cluster
// as warped_plan gives them.
at::Tensor warped_correlation(const at::Tensor& f1, const at::Tensor& f2, const at::Tensor& flow,
                              double scale, int64_t md, int64_t px, int64_t cluster) {
  const char* what = "the warped correlation";
  check_warped(what, f1, f2, flow, md);
  const at::Device device = f1.device();
  const int64_t B = f1.size(0), C = f1.size(1), H = f1.size(2), W = f1.size(3);
  TORCH_CHECK_VALUE(px == 1 || px == 2, what, " px ", px, "; takes 1 or 2");
  TORCH_CHECK_VALUE(cluster >= 1 && cluster <= kMaxCluster && cluster <= (C + 3) / 4, what,
                    " cluster ", cluster, " for C = ", C);
  c10::OptionalDeviceGuard guard(device);
  at::Tensor out = at::empty({B, (2 * md + 1) * (2 * md + 1), H, W},
                             f1.options().memory_format(at::MemoryFormat::ChannelsLast));
  const int err = dsfm_warped_correlation(
      f1.data_ptr(), f2.data_ptr(), flow.data_ptr(), flow.scalar_type() == at::kFloat ? 0 : 1,
      flow.stride(0), flow.stride(1), flow.stride(2), flow.stride(3), static_cast<float>(scale),
      out.data_ptr(), B, H, W, C, md, px, cluster,
      f1.scalar_type() == at::kFloat ? 0 : 1, current_stream(device));
  TORCH_CHECK(err == 0, what, " launch failed: cudaError ", err);
  return out;
}

// The backward kernels' mapping, as ops/cuda/local_corr.py::backward_plan
// gives it: a tile of tile_h >= 1 rows and tile_w columns (a multiple of
// run, which is 1, 2 or 4 pixels a thread), slots (a power of two) of kSlot
// channels a block, at most
// kMaxBackwardThreads threads, and with a flow at most kMaxCluster channel
// groups (one cluster a tile). The launcher refuses a mapping whose shared
// memory exceeds a block's (the launch fails).
void check_backward_plan(const char* what, int64_t C, int64_t tile_h, int64_t tile_w,
                         int64_t run, int64_t slots, bool flow) {
  TORCH_CHECK_VALUE((run == 1 || run == 2 || run == 4) && tile_h >= 1 && tile_w >= run &&
                        tile_w % run == 0 && slots >= 1 && (slots & (slots - 1)) == 0 &&
                        tile_h * (tile_w / run) * slots <= kMaxBackwardThreads,
                    what, " mapping ", tile_h, "x", tile_w, " run ", run, " slots ", slots,
                    "; takes a run of 1, 2 or 4, a tile of >= 1 rows and a multiple of the run "
                    "in columns, a power of two of slots and at most ", kMaxBackwardThreads,
                    " threads (rows x columns / run x slots)");
  const int64_t groups = (C + slots * kSlot - 1) / (slots * kSlot);
  TORCH_CHECK_VALUE(!flow || groups <= kMaxCluster, what, " slots ", slots, " for C = ", C,
                    ": ", groups, " channel groups, one cluster takes at most ", kMaxCluster);
}

// B2's backward: f0, f1 (B, H, W, C) float32 contiguous as the forward
// took them, dout (B, H, W, (2md+1)^2) float32 contiguous -> (d f0, d f1),
// float32 contiguous; the mapping as backward_plan gives it.
std::tuple<at::Tensor, at::Tensor> local_correlation_backward(const at::Tensor& f0,
                                                              const at::Tensor& f1,
                                                              const at::Tensor& dout,
                                                              int64_t md, int64_t tile_h,
                                                              int64_t tile_w, int64_t run,
                                                              int64_t slots) {
  const char* what = "B2 backward";
  TORCH_CHECK_VALUE(f0.is_cuda(), what, " takes CUDA tensors only");
  check_features(what, "f0", f0, f0.device(), f0.sizes());
  check_features(what, "f1", f1, f0.device(), f0.sizes());
  check_shape(what, f0, md, 1, 1);
  const int64_t B = f0.size(0), H = f0.size(1), W = f0.size(2), C = f0.size(3);
  const int64_t s2 = (2 * md + 1) * (2 * md + 1);
  check_features(what, "dout", dout, f0.device(), {B, H, W, s2});
  check_backward_plan(what, C, tile_h, tile_w, run, slots, false);
  c10::OptionalDeviceGuard guard(f0.device());
  at::Tensor df0 = at::empty_like(f0), df1 = at::empty_like(f1);
  const int err = dsfm_local_correlation_backward(f0.data_ptr(), f1.data_ptr(), dout.data_ptr(),
                                                  df0.data_ptr(), df1.data_ptr(), B, H, W, C,
                                                  md, tile_h, tile_w, run, slots,
                                                  current_stream(f0.device()));
  TORCH_CHECK(err == 0, what, " launch failed: cudaError ", err);
  return {df0, df1};
}

// The warped correlation's backward: f1, f2, flow, scale, md as the forward
// took them; dout (B, (2md+1)^2, H, W) of f1's dtype with its channels
// adjacent and its pixels at one stride (channels-last, or a slice of a
// channels-last tensor's channels) -> (d f1, d f2) channels-last of f1's
// dtype, d flow of the flow's dtype and strides (where the flow's are
// dense); the mapping as backward_plan gives it.
std::tuple<at::Tensor, at::Tensor, at::Tensor> warped_correlation_backward(
    const at::Tensor& f1, const at::Tensor& f2, const at::Tensor& flow, double scale,
    const at::Tensor& dout, int64_t md, int64_t tile_h, int64_t tile_w, int64_t run,
    int64_t slots) {
  const char* what = "the warped correlation's backward";
  check_warped(what, f1, f2, flow, md);
  const at::Device device = f1.device();
  const int64_t B = f1.size(0), C = f1.size(1), H = f1.size(2), W = f1.size(3);
  const int64_t s2 = (2 * md + 1) * (2 * md + 1);
  TORCH_CHECK_VALUE(dout.is_cuda() && dout.device() == device, what, " dout on ",
                    dout.device());
  TORCH_CHECK_TYPE(dout.scalar_type() == f1.scalar_type(), what, " dout ", dout.scalar_type(),
                   "; takes f1's dtype ", f1.scalar_type());
  TORCH_CHECK_VALUE(dout.dim() == 4 && dout.size(0) == B && dout.size(1) == s2 &&
                        dout.size(2) == H && dout.size(3) == W,
                    what, " dout ", dout.sizes(), "; takes (", B, ", ", s2, ", ", H, ", ", W,
                    ")");
  TORCH_CHECK_VALUE(dout.stride(1) == 1 && dout.stride(3) >= s2 &&
                        dout.stride(2) == W * dout.stride(3) && dout.stride(0) >= 0 &&
                        dout.storage_offset() >= 0,
                    what, " takes dout with adjacent channels and one pixel stride; got "
                    "strides ", dout.strides());
  check_backward_plan(what, C, tile_h, tile_w, run, slots, true);
  c10::OptionalDeviceGuard guard(device);
  const auto cl = at::MemoryFormat::ChannelsLast;
  const bool f32 = f1.scalar_type() == at::kFloat;
  at::Tensor df1 = at::empty({B, C, H, W}, f1.options().memory_format(cl));
  // zeroed in place: at::zeros does not keep the options' memory format
  at::Tensor acc = at::empty({B, C, H, W}, f1.options().dtype(at::kFloat).memory_format(cl));
  acc.zero_();
  // d f2's scatter adds 4 channels at a time with one 16-byte reduction
  // where C % 4 == 0 (every C PWC-DC uses: 128, 96, 64, 32), which needs
  // the buffer 16-byte aligned; other C take scalar atomics
  TORCH_CHECK(reinterpret_cast<uintptr_t>(acc.data_ptr()) % 16 == 0, what,
              ": d f2's float32 buffer must start 16-byte aligned (its 4-channel reductions)");
  at::Tensor df2 = f32 ? acc : at::empty({B, C, H, W}, f1.options().memory_format(cl));
  at::Tensor dflow = at::empty_like(flow);
  check_strides(what, "d flow", dflow);
  const int err = dsfm_warped_correlation_backward(
      f1.data_ptr(), f2.data_ptr(), flow.data_ptr(), flow.scalar_type() == at::kFloat ? 0 : 1,
      flow.stride(0), flow.stride(1), flow.stride(2), flow.stride(3), static_cast<float>(scale),
      dout.data_ptr(), dout.stride(0), dout.stride(3), df1.data_ptr(), df2.data_ptr(),
      acc.data_ptr<float>(), dflow.data_ptr(), dflow.stride(0), dflow.stride(1),
      dflow.stride(2), dflow.stride(3), B, H, W, C, md, f32 ? 0 : 1, tile_h, tile_w, run, slots,
      current_stream(device));
  TORCH_CHECK(err == 0, what, " launch failed: cudaError ", err);
  return {df1, df2, dflow};
}

}  // namespace

TORCH_LIBRARY(dsfm_corr, m) {
  m.def("local_correlation(Tensor f0, Tensor f1, int md, int px, int cluster) -> Tensor");
  m.def("warped_correlation(Tensor f1, Tensor f2, Tensor flow, float scale, int md, int px, "
        "int cluster) -> Tensor");
  m.def("local_correlation_backward(Tensor f0, Tensor f1, Tensor dout, int md, int tile_h, "
        "int tile_w, int run, int slots) -> (Tensor, Tensor)");
  m.def("warped_correlation_backward(Tensor f1, Tensor f2, Tensor flow, float scale, "
        "Tensor dout, int md, int tile_h, int tile_w, int run, int slots) -> "
        "(Tensor, Tensor, Tensor)");
}

// Registered for every dispatch key: a CPU tensor reaches the checks, which
// refuse it.
TORCH_LIBRARY_IMPL(dsfm_corr, CompositeExplicitAutograd, m) {
  m.impl("local_correlation", &local_correlation);
  m.impl("warped_correlation", &warped_correlation);
  m.impl("local_correlation_backward", &local_correlation_backward);
  m.impl("warped_correlation_backward", &warped_correlation_backward);
}
