// Kernels K1 and K2 (sweep_corr.cu) as PyTorch operators (namespace
// `dsfm_sweep`): REGNet's sweep correlation and its backward, which
// ops/camera.py::SweepCorrelationFn launches through
// ops/cuda/sweep_corr.py.
//
// As for B1 (sweep_warp_ops.cpp says why): each launch is one dispatcher
// call from Python, with the checks, the allocation, the device guard, the
// current stream and the launch in C++, and nothing synchronises.
//
// Host code only: it calls the plain C launchers of sweep_corr.cu, whose
// library it links. ops/cuda/sweep_corr.py builds it with nvcc against
// torch.utils.cpp_extension's include and library paths and loads it with
// torch.ops.load_library.

#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/zeros.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <cstdint>
#include <tuple>

extern "C" {
int dsfm_sweep_correlation(const void* ref, const void* tgt, const void* depths, const void* M,
                           const void* Kt, void* out, int B, int S, int D, int H, int W, int C,
                           int dtype, void* stream);
int dsfm_sweep_correlation_backward(const void* g, const void* ref, const void* tgt,
                                    const void* depths, const void* M, const void* Kt,
                                    void* dref, void* dtgt, int B, int S, int D, int H, int W,
                                    int C, int dtype, void* stream);
}

namespace {

constexpr int64_t kMaxRowBytes = 16 * 256;   // K2: a 16-byte chunk a thread, 256 threads a block

void* current_stream(const at::Device& device) {
  return c10::impl::getDeviceGuardImpl(device.type())->getStream(device).native_handle();
}

// ref, tgt (B, H, W, C) CUDA, contiguous, one dtype (float32 or bfloat16),
// 16-byte aligned, rows of C channels a multiple of 16 bytes up to
// kMaxRowBytes; depths (D,), M (B S, 3, 3), Kt (B S, 3) float32, contiguous,
// on the features' device. Returns the dtype code (0 float32, 1 bfloat16).
int check_args(const char* what, const at::Tensor& ref, const at::Tensor& tgt,
               const at::Tensor& depths, const at::Tensor& M, const at::Tensor& Kt,
               int64_t S) {
  TORCH_CHECK_VALUE(ref.is_cuda(), "the ", what, " takes CUDA tensors only");
  for (const at::Tensor* t : {&tgt, &depths, &M, &Kt})
    TORCH_CHECK_VALUE(t->is_cuda() && t->device() == ref.device(), what, " inputs on ",
                      t->device(), " and ", ref.device());
  TORCH_CHECK_TYPE(ref.scalar_type() == at::kFloat || ref.scalar_type() == at::kBFloat16, what,
                   " dtype ", ref.scalar_type(), "; takes float32 or bfloat16");
  TORCH_CHECK_TYPE(tgt.scalar_type() == ref.scalar_type(), what, " features of dtypes ",
                   ref.scalar_type(), " and ", tgt.scalar_type());
  for (const at::Tensor* t : {&depths, &M, &Kt})
    TORCH_CHECK_TYPE(t->scalar_type() == at::kFloat, what, " depths, M and Kt must be float32");
  TORCH_CHECK_VALUE(ref.dim() == 4 && tgt.sizes() == ref.sizes(), what, " shapes ref ",
                    ref.sizes(), ", tgt ", tgt.sizes());
  const int64_t B = ref.size(0), H = ref.size(1), W = ref.size(2), C = ref.size(3);
  TORCH_CHECK_VALUE(B >= 1 && H >= 1 && W >= 1 && S >= 1 && B * S < (int64_t(1) << 31) &&
                        H * W < (int64_t(1) << 31),
                    what, " ref ", ref.sizes(), " with ", S, " poses out of range");
  TORCH_CHECK_VALUE(depths.dim() == 1 && depths.size(0) >= 1 && M.dim() == 3 &&
                        M.size(0) == B * S && M.size(1) == 3 && M.size(2) == 3 &&
                        Kt.dim() == 2 && Kt.size(0) == B * S && Kt.size(1) == 3,
                    what, " depths ", depths.sizes(), ", M ", M.sizes(), ", Kt ", Kt.sizes(),
                    " for B S = ", B * S);
  for (const at::Tensor* t : {&ref, &tgt, &depths, &M, &Kt})
    TORCH_CHECK_VALUE(t->is_contiguous(), "the ", what, " takes contiguous inputs");
  const int64_t row = C * ref.element_size();
  TORCH_CHECK_VALUE(row % 16 == 0 && row <= kMaxRowBytes, what, " feature rows of ", row,
                    " bytes; takes a multiple of 16 up to ", kMaxRowBytes);
  for (const at::Tensor* t : {&ref, &tgt})
    TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0, what,
                      " features must be 16-byte aligned");
  return ref.scalar_type() == at::kBFloat16 ? 1 : 0;
}

void check_launch(int err, const char* what) {
  TORCH_CHECK(err == 0, what, " launch failed: cudaError ", err);
}

// ref, tgt (B, H, W, C); depths (D,); M (B S, 3, 3), Kt (B S, 3) -> the
// (B, S, D, H, W) float32 correlation with channels-last-3d strides: memory
// order (B, D, H, W, S). K1.
at::Tensor sweep_correlation(const at::Tensor& ref, const at::Tensor& tgt,
                             const at::Tensor& depths, const at::Tensor& M,
                             const at::Tensor& Kt) {
  const char* what = "sweep correlation (K1)";
  TORCH_CHECK_VALUE(ref.dim() == 4 && ref.size(0) >= 1 && M.dim() == 3, what, " shapes ref ",
                    ref.sizes(), ", M ", M.sizes());
  const int64_t B = ref.size(0), S = M.size(0) / B;
  const int code = check_args(what, ref, tgt, depths, M, Kt, S);
  const int64_t H = ref.size(1), W = ref.size(2), C = ref.size(3), D = depths.size(0);
  c10::OptionalDeviceGuard guard(ref.device());
  at::Tensor out = at::empty({B, S, D, H, W}, ref.options().dtype(at::kFloat),
                             at::MemoryFormat::ChannelsLast3d);
  check_launch(dsfm_sweep_correlation(ref.data_ptr(), tgt.data_ptr(), depths.data_ptr(),
                                      M.data_ptr(), Kt.data_ptr(), out.data_ptr(), B, S, D, H,
                                      W, C, code, current_stream(ref.device())),
               what);
  return out;
}

// g (B, S, D, H, W) float32 with channels-last-3d strides, the
// correlation's gradient; the rest as the forward took them -> (dref, dtgt),
// each (B, H, W, C) in the features' dtype. dtgt is summed in a zeroed
// float32 buffer, then cast for bfloat16 features. K2.
std::tuple<at::Tensor, at::Tensor> sweep_correlation_backward(
    const at::Tensor& g, const at::Tensor& ref, const at::Tensor& tgt, const at::Tensor& depths,
    const at::Tensor& M, const at::Tensor& Kt) {
  const char* what = "sweep correlation backward (K2)";
  TORCH_CHECK_VALUE(ref.dim() == 4 && ref.size(0) >= 1 && M.dim() == 3, what, " shapes ref ",
                    ref.sizes(), ", M ", M.sizes());
  const int64_t B = ref.size(0), S = M.size(0) / B;
  const int code = check_args(what, ref, tgt, depths, M, Kt, S);
  const int64_t H = ref.size(1), W = ref.size(2), C = ref.size(3), D = depths.size(0);
  TORCH_CHECK_VALUE(g.is_cuda() && g.device() == ref.device(), what, " g on ", g.device(),
                    ", features on ", ref.device());
  TORCH_CHECK_TYPE(g.scalar_type() == at::kFloat, what, " g dtype ", g.scalar_type(),
                   "; takes float32");
  TORCH_CHECK_VALUE(g.dim() == 5 && g.size(0) == B && g.size(1) == S && g.size(2) == D &&
                        g.size(3) == H && g.size(4) == W &&
                        g.is_contiguous(at::MemoryFormat::ChannelsLast3d),
                    what, " takes g (", B, ", ", S, ", ", D, ", ", H, ", ", W,
                    ") with channels-last-3d strides; got ", g.sizes(), " strides ",
                    g.strides());
  c10::OptionalDeviceGuard guard(ref.device());
  at::Tensor dref = at::empty_like(ref);
  at::Tensor acc = at::zeros({B, H, W, C}, ref.options().dtype(at::kFloat));
  check_launch(dsfm_sweep_correlation_backward(g.data_ptr(), ref.data_ptr(), tgt.data_ptr(),
                                               depths.data_ptr(), M.data_ptr(), Kt.data_ptr(),
                                               dref.data_ptr(), acc.data_ptr(), B, S, D, H, W,
                                               C, code, current_stream(ref.device())),
               what);
  return {dref, code == 0 ? acc : acc.to(at::kBFloat16)};
}

}  // namespace

TORCH_LIBRARY(dsfm_sweep, m) {
  m.def("sweep_correlation(Tensor ref, Tensor tgt, Tensor depths, Tensor M, Tensor Kt) -> Tensor");
  m.def("sweep_correlation_backward(Tensor g, Tensor ref, Tensor tgt, Tensor depths, Tensor M, "
        "Tensor Kt) -> (Tensor, Tensor)");
}

// Registered for every dispatch key: a CPU tensor reaches the checks, which
// refuse it.
TORCH_LIBRARY_IMPL(dsfm_sweep, CompositeExplicitAutograd, m) {
  m.impl("sweep_correlation", &sweep_correlation);
  m.impl("sweep_correlation_backward", &sweep_correlation_backward);
}
