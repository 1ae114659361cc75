// Kernel B2's entry points as PyTorch operators (namespace `dsfm_corr`):
// the windowed correlation (local_corr.cu) and the warped correlation that
// PWC-DC's levels 5..2 launch (warped_corr.cu), in PWC-DC's NCHW layout and
// dtype.
//
// As for B1 (sweep_warp_ops.cpp, which says why): each launch is one
// dispatcher call from Python, with the checks, the allocation, the device
// guard, the current stream (the capture stream inside `torch.cuda.graph`)
// and the launch in C++, and nothing synchronises, so PWC-DC's flow stage
// can be captured in a CUDA graph. The work mappings come from
// ops/cuda/local_corr.py::plan and ::warped_plan, which the CPU tests replay.
//
// Host code only: it calls the plain C launchers of local_corr.cu and
// warped_corr.cu, whose libraries it links. ops/cuda/local_corr.py builds it with nvcc against
// torch.utils.cpp_extension's include and library paths and loads it with
// torch.ops.load_library.

#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <algorithm>
#include <utility>

extern "C" {
int dsfm_local_correlation(const void* f0, const void* f1, void* out, int B, int H, int W, int C,
                           int md, int px, int cluster, void* stream);
int dsfm_warped_correlation(const void* f1, const void* f2, const void* flow, int flow_dtype,
                            int fs_b, int fs_k, int fs_y, int fs_x, float scale, void* out, int B,
                            int H, int W, int C, int md, int px, int cluster, int dtype,
                            void* stream);
}

namespace {

constexpr int64_t kMaxMd = 4, kMaxCluster = 8;

void* current_stream(const at::Device& device) {
  return c10::impl::getDeviceGuardImpl(device.type())->getStream(device).native_handle();
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

// f1, f2 (B, C, H, W) of one dtype, float32 or bfloat16, channels-last
// contiguous; flow (B, 2, H, W) float32 or bfloat16, any strides; the
// flow's scale -> (B, (2md+1)^2, H, W) of f1's dtype, channels-last: the
// correlation of f1 with f2 sampled at q + scale flow(q); px and cluster
// as warped_plan gives them.
at::Tensor warped_correlation(const at::Tensor& f1, const at::Tensor& f2, const at::Tensor& flow,
                              double scale, int64_t md, int64_t px, int64_t cluster) {
  const char* what = "the warped correlation";
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
  int64_t reach = 0;   // the flow's last element, from its strides
  for (int d = 0; d < 4; ++d) reach += (flow.size(d) - 1) * flow.stride(d);
  TORCH_CHECK_VALUE(flow.storage_offset() >= 0 && reach < (int64_t(1) << 31) &&
                        *std::min_element(flow.strides().begin(), flow.strides().end()) >= 0,
                    what, " flow strides ", flow.strides(), " out of range");
  TORCH_CHECK_VALUE(md >= 1 && md <= kMaxMd, what, " max displacement ", md, "; takes 1..",
                    kMaxMd);
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

}  // namespace

TORCH_LIBRARY(dsfm_corr, m) {
  m.def("local_correlation(Tensor f0, Tensor f1, int md, int px, int cluster) -> Tensor");
  m.def("warped_correlation(Tensor f1, Tensor f2, Tensor flow, float scale, int md, int px, "
        "int cluster) -> Tensor");
}

// Registered for every dispatch key: a CPU tensor reaches the checks, which
// refuse it.
TORCH_LIBRARY_IMPL(dsfm_corr, CompositeExplicitAutograd, m) {
  m.impl("local_correlation", &local_correlation);
  m.impl("warped_correlation", &warped_correlation);
}
