// Kernels R1 and R2 (raft_lookup.cu) as PyTorch operators (namespace
// `dsfm_raft`): RAFT's correlation lookup over all levels of its pyramid,
// and its backward, which models/raft.py::RaftLookupFn launches.
//
// As for B1 and B2 (sweep_warp_ops.cpp says why): each launch is one
// dispatcher call from Python, with the checks, the allocation, the device
// guard, the current stream and the launch in C++, and nothing
// synchronises.
//
// Host code only: it calls the plain C launchers of raft_lookup.cu, whose
// library it links. ops/cuda/raft_lookup.py builds it with nvcc against
// torch.utils.cpp_extension's include and library paths and loads it with
// torch.ops.load_library.

#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <cstdint>
#include <vector>

extern "C" {
int dsfm_raft_lookup(const void* const* levels, const int* heights, const int* widths,
                     int n_levels, const void* coords, void* out, long long Q, int radius,
                     int in_bf16, int out_bf16, void* stream);
int dsfm_raft_lookup_backward(const void* const* levels, void* const* grads, const int* heights,
                              const int* widths, int n_levels, const void* coords,
                              const void* dout, void* dcoords, long long Q, int radius,
                              int lv_bf16, int g_bf16, void* stream);
}

namespace {

constexpr int64_t kMaxLevels = 4, kMaxRadius = 4;

void* current_stream(const at::Device& device) {
  return c10::impl::getDeviceGuardImpl(device.type())->getStream(device).native_handle();
}

bool is_float_or_bf16(const at::Tensor& t) {
  return t.scalar_type() == at::kFloat || t.scalar_type() == at::kBFloat16;
}

// coords (B, h, w, 2) float32 contiguous on a card; levels: 1..4 tensors
// (B h w, Hl, Wl) of one dtype, float32 or bfloat16, contiguous, on the
// coordinates' device; radius 1..4. Fills the host arrays of the launch.
void check_lookup(const char* what, const at::Tensor& coords, at::TensorList levels,
                  int64_t radius, std::vector<const void*>& ptrs, std::vector<int>& heights,
                  std::vector<int>& widths) {
  TORCH_CHECK_VALUE(coords.is_cuda(), what, " takes CUDA tensors only");
  TORCH_CHECK_TYPE(coords.scalar_type() == at::kFloat, what, " coords dtype ",
                   coords.scalar_type(), "; takes float32");
  TORCH_CHECK_VALUE(coords.dim() == 4 && coords.size(3) == 2 && coords.is_contiguous(), what,
                    " takes contiguous coords (B, h, w, 2); got ", coords.sizes());
  const int64_t Q = coords.size(0) * coords.size(1) * coords.size(2);
  TORCH_CHECK_VALUE(Q >= 1 && Q < (int64_t(1) << 31), what, " coords ", coords.sizes(),
                    " out of range");
  TORCH_CHECK_VALUE(radius >= 1 && radius <= kMaxRadius, what, " radius ", radius,
                    "; takes 1..", kMaxRadius);
  const int64_t n = static_cast<int64_t>(levels.size());
  TORCH_CHECK_VALUE(n >= 1 && n <= kMaxLevels, what, " takes 1..", kMaxLevels, " levels; got ",
                    n);
  for (int64_t i = 0; i < n; ++i) {
    const at::Tensor& t = levels[i];
    TORCH_CHECK_VALUE(t.is_cuda() && t.device() == coords.device(), what, " level ", i, " on ",
                      t.device(), ", coords on ", coords.device());
    TORCH_CHECK_TYPE(is_float_or_bf16(t) && t.scalar_type() == levels[0].scalar_type(), what,
                     " level ", i, " dtype ", t.scalar_type(),
                     "; takes one dtype, float32 or bfloat16");
    TORCH_CHECK_VALUE(t.dim() == 3 && t.size(0) == Q && t.size(1) >= 1 && t.size(2) >= 1 &&
                          t.size(1) * t.size(2) < (int64_t(1) << 31) && t.is_contiguous(),
                      what, " takes contiguous levels (", Q, ", Hl, Wl); level ", i, " ",
                      t.sizes());
    ptrs.push_back(t.data_ptr());
    heights.push_back(static_cast<int>(t.size(1)));
    widths.push_back(static_cast<int>(t.size(2)));
  }
}

// coords (B, h, w, 2) float32, levels (B h w, Hl, Wl), radius -> (B, h, w,
// L (2 radius + 1)^2) in out_dtype (float32 or bfloat16): R1.
at::Tensor raft_lookup(const at::Tensor& coords, at::TensorList levels, int64_t radius,
                       at::ScalarType out_dtype) {
  const char* what = "R1 (the RAFT lookup)";
  std::vector<const void*> ptrs;
  std::vector<int> heights, widths;
  check_lookup(what, coords, levels, radius, ptrs, heights, widths);
  TORCH_CHECK_TYPE(out_dtype == at::kFloat || out_dtype == at::kBFloat16, what, " out dtype ",
                   out_dtype, "; takes float32 or bfloat16");
  const int64_t K = (2 * radius + 1) * (2 * radius + 1), n = levels.size();
  const int64_t Q = coords.size(0) * coords.size(1) * coords.size(2);
  c10::OptionalDeviceGuard guard(coords.device());
  at::Tensor out = at::empty({coords.size(0), coords.size(1), coords.size(2), n * K},
                             coords.options().dtype(out_dtype));
  const int err = dsfm_raft_lookup(ptrs.data(), heights.data(), widths.data(),
                                   static_cast<int>(n), coords.data_ptr(), out.data_ptr(), Q,
                                   static_cast<int>(radius),
                                   levels[0].scalar_type() == at::kBFloat16,
                                   out_dtype == at::kBFloat16,
                                   current_stream(coords.device()));
  TORCH_CHECK(err == 0, what, " launch failed: cudaError ", err);
  return out;
}

// As raft_lookup, with dout (B, h, w, L (2 radius + 1)^2) float32 or
// bfloat16: adds each query's patch gradient into grads (one accumulator a
// level of its level's shape and dtype, contiguous) in place and returns d
// coords (B, h, w, 2) float32: R2.
at::Tensor raft_lookup_backward(const at::Tensor& coords, at::TensorList levels,
                                const at::Tensor& dout, at::TensorList grads, int64_t radius) {
  const char* what = "R2 (the RAFT lookup's backward)";
  std::vector<const void*> ptrs;
  std::vector<int> heights, widths;
  check_lookup(what, coords, levels, radius, ptrs, heights, widths);
  const int64_t K = (2 * radius + 1) * (2 * radius + 1), n = levels.size();
  const int64_t Q = coords.size(0) * coords.size(1) * coords.size(2);
  TORCH_CHECK_VALUE(dout.is_cuda() && dout.device() == coords.device(), what, " dout on ",
                    dout.device(), ", coords on ", coords.device());
  TORCH_CHECK_TYPE(is_float_or_bf16(dout), what, " dout dtype ", dout.scalar_type(),
                   "; takes float32 or bfloat16");
  TORCH_CHECK_VALUE(dout.dim() == 4 && dout.size(0) == coords.size(0) &&
                        dout.size(1) == coords.size(1) && dout.size(2) == coords.size(2) &&
                        dout.size(3) == n * K && dout.is_contiguous(),
                    what, " takes a contiguous dout (", coords.size(0), ", ", coords.size(1),
                    ", ", coords.size(2), ", ", n * K, "); got ", dout.sizes());
  TORCH_CHECK_VALUE(static_cast<int64_t>(grads.size()) == n, what,
                    " takes one accumulator a level; got ", grads.size());
  std::vector<void*> gptrs;
  for (size_t i = 0; i < grads.size(); ++i) {
    const at::Tensor& t = grads[i];
    TORCH_CHECK_VALUE(t.device() == coords.device() &&
                          t.scalar_type() == levels[i].scalar_type() &&
                          t.sizes() == levels[i].sizes() && t.is_contiguous(),
                      what, " accumulator ", i, " must be contiguous, of level ", i,
                      "'s shape and dtype on its device; got ", t.scalar_type(), " ",
                      t.sizes(), " on ", t.device());
    gptrs.push_back(t.data_ptr());
  }
  c10::OptionalDeviceGuard guard(coords.device());
  at::Tensor dcoords = at::empty_like(coords);
  const int err = dsfm_raft_lookup_backward(
      ptrs.data(), gptrs.data(), heights.data(), widths.data(),
      static_cast<int>(n), coords.data_ptr(), dout.data_ptr(), dcoords.data_ptr(), Q,
      static_cast<int>(radius), levels[0].scalar_type() == at::kBFloat16,
      dout.scalar_type() == at::kBFloat16, current_stream(coords.device()));
  TORCH_CHECK(err == 0, what, " launch failed: cudaError ", err);
  return dcoords;
}

}  // namespace

TORCH_LIBRARY(dsfm_raft, m) {
  m.def("raft_lookup(Tensor coords, Tensor[] levels, int radius, ScalarType out_dtype) -> Tensor");
  m.def("raft_lookup_backward(Tensor coords, Tensor[] levels, Tensor dout, Tensor(a!)[] grads, "
        "int radius) -> Tensor");
}

// Registered for every dispatch key: a CPU tensor reaches the checks, which
// refuse it.
TORCH_LIBRARY_IMPL(dsfm_raft, CompositeExplicitAutograd, m) {
  m.impl("raft_lookup", &raft_lookup);
  m.impl("raft_lookup_backward", &raft_lookup_backward);
}
