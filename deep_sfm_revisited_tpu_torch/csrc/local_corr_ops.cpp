// Kernel B2's entry points as PyTorch operators (namespace `dsfm_corr`):
// the windowed correlation and the warped correlation that PWC-DC's levels
// 5..2 launch.
//
// As for B1 (sweep_warp_ops.cpp, which says why): each launch is one
// dispatcher call from Python, with the checks, the allocation, the device
// guard, the current stream (the capture stream inside `torch.cuda.graph`)
// and the launch in C++, and nothing synchronises, so PWC-DC's flow stage
// can be captured in a CUDA graph. The work mapping (px, cluster) comes from
// ops/cuda/local_corr.py::plan, which the CPU tests replay.
//
// Host code only: it calls the plain C launchers of local_corr.cu, whose
// library it links. ops/cuda/local_corr.py builds it with nvcc against
// torch.utils.cpp_extension's include and library paths and loads it with
// torch.ops.load_library.

#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

extern "C" {
int dsfm_local_correlation(const void* f0, const void* f1, void* out, int B, int H, int W, int C,
                           int md, int px, int cluster, void* stream);
int dsfm_warped_correlation(const void* f1, const void* f2, const void* flow, float scale,
                            void* out, int B, int H, int W, int C, int md, int px, int cluster,
                            int dtype, void* stream);
}

namespace {

constexpr int64_t kMaxMd = 4, kMaxCluster = 8;

void* current_stream(const at::Device& device) {
  return c10::impl::getDeviceGuardImpl(device.type())->getStream(device).native_handle();
}

// a (B, H, W, C) float32 or, where `any_float` is set, bfloat16 feature map
// on `device`, contiguous, of `shape`
void check_features(const char* what, const char* name, const at::Tensor& t,
                    const at::Device& device, at::IntArrayRef shape, bool any_float) {
  TORCH_CHECK_VALUE(t.is_cuda() && t.device() == device, what, " takes CUDA tensors on one "
                    "device; ", name, " on ", t.device());
  TORCH_CHECK_TYPE(t.scalar_type() == at::kFloat ||
                       (any_float && t.scalar_type() == at::kBFloat16),
                   what, " ", name, " dtype ", t.scalar_type(), "; takes float32",
                   any_float ? " or bfloat16" : "");
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
  check_features(what, "f0", f0, f0.device(), f0.sizes(), false);
  check_features(what, "f1", f1, f0.device(), f0.sizes(), false);
  check_shape(what, f0, md, px, cluster);
  const int64_t B = f0.size(0), H = f0.size(1), W = f0.size(2), C = f0.size(3);
  c10::OptionalDeviceGuard guard(f0.device());
  at::Tensor out = at::empty({B, H, W, (2 * md + 1) * (2 * md + 1)}, f0.options());
  const int err = dsfm_local_correlation(f0.data_ptr(), f1.data_ptr(), out.data_ptr(), B, H, W,
                                         C, md, px, cluster, current_stream(f0.device()));
  TORCH_CHECK(err == 0, what, " launch failed: cudaError ", err);
  return out;
}

// f1 (B, H, W, C) float32, f2 (B, H, W, C) float32 or bfloat16, flow
// (B, 2, H, W) float32, the flow's scale -> (B, H, W, (2md+1)^2) float32:
// the correlation of f1 with f2 sampled at q + scale flow(q)
at::Tensor warped_correlation(const at::Tensor& f1, const at::Tensor& f2, const at::Tensor& flow,
                              double scale, int64_t md, int64_t px, int64_t cluster) {
  const char* what = "the warped correlation";
  TORCH_CHECK_VALUE(f1.is_cuda(), what, " takes CUDA tensors only");
  check_features(what, "f1", f1, f1.device(), f1.sizes(), false);
  check_features(what, "f2", f2, f1.device(), f1.sizes(), true);
  check_shape(what, f1, md, px, cluster);
  const int64_t B = f1.size(0), H = f1.size(1), W = f1.size(2), C = f1.size(3);
  TORCH_CHECK_VALUE(flow.is_cuda() && flow.device() == f1.device(), what, " flow on ",
                    flow.device());
  TORCH_CHECK_TYPE(flow.scalar_type() == at::kFloat, what, " flow dtype ", flow.scalar_type(),
                   "; takes float32");
  TORCH_CHECK_VALUE(flow.dim() == 4 && flow.size(0) == B && flow.size(1) == 2 &&
                        flow.size(2) == H && flow.size(3) == W && flow.is_contiguous(),
                    what, " flow ", flow.sizes(), "; takes a contiguous (", B, ", 2, ", H, ", ",
                    W, ")");
  c10::OptionalDeviceGuard guard(f1.device());
  at::Tensor out = at::empty({B, H, W, (2 * md + 1) * (2 * md + 1)}, f1.options());
  const int err = dsfm_warped_correlation(
      f1.data_ptr(), f2.data_ptr(), flow.data_ptr(), static_cast<float>(scale), out.data_ptr(),
      B, H, W, C, md, px, cluster, f2.scalar_type() == at::kFloat ? 0 : 1,
      current_stream(f1.device()));
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
