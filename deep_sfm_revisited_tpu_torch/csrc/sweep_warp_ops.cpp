// Kernel B1's entry points as PyTorch operators (namespace `dsfm`).
//
// The gather's kernel takes ~2 us on the card, so the host path around its
// launch sets its pace: a Python wrapper that allocates the output and
// calls the kernel library through ctypes spends ~16 us a call, more than
// one dispatch of `F.grid_sample`. Registered here, each entry point is one
// dispatcher call from Python: the checks, the allocation (the caching
// allocator, from C++), the device guard (a no-op on the current device),
// the current stream (the capture stream inside `torch.cuda.graph`) and the
// launch all run in C++. Nothing synchronises, so the gather can be
// captured in a CUDA graph.
//
// This file is host code only: it includes no CUDA header, and calls the
// kernels through the plain C launchers of sweep_warp.cu, whose library it
// links. ops/cuda/sweep_warp.py builds it with nvcc against
// torch.utils.cpp_extension's include and library paths and loads it with
// torch.ops.load_library.

#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <optional>
#include <tuple>

extern "C" {
int dsfm_bilinear_sample(const void* img, const void* coords, void* out, int B, int H, int W,
                         int C, long long Q, int dtype, int vector, void* stream);
int dsfm_plane_sweep_volume(const void* ref, const void* tgt, const void* depths,
                            const void* M, const void* Kt, void* out, int B, int D, int H,
                            int W, int C, int dtype, void* stream);
int dsfm_plane_sweep_volume_backward_probe(const void* dvol, const void* depths, const void* M,
                                           const void* Kt, void* dref, void* dtgt, int B,
                                           int D, int H, int W, int C, int dtype, int tile_h,
                                           int tile_w, int planes, int smem_bytes, void* stats,
                                           void* stream);
long long dsfm_plane_sweep_volume_pose_grad_blocks(int B, int D, int H, int W, int C,
                                                   int dtype);
int dsfm_plane_sweep_volume_pose_grad(const void* dvol, const void* tgt, const void* depths,
                                      const void* M, const void* Kt, void* partial, void* dM,
                                      void* dKt, int B, int D, int H, int W, int C, int dtype,
                                      void* stream);
int dsfm_displacement_volume(const void* x, const void* y, const void* flow, void* out, int B,
                             int C, int h, int w, int md, int dtype, int vec_bytes, int tile_w,
                             int band_h, int fused, int grid, void* stream);
int dsfm_displacement_volume_backward(const void* dout, const void* y, const void* flow,
                                      void* dx, void* dy, void* acc, int B, int C, int h, int w,
                                      int md, int dtype, void* stream);
}

namespace {

constexpr int64_t kMaxRowBytes = 16 * 256;   // the sweep kernels: a 16-byte chunk a thread

int dtype_code(const at::Tensor& t, const char* what) {
  if (t.scalar_type() == at::kFloat) return 0;
  if (t.scalar_type() == at::kBFloat16) return 1;
  TORCH_CHECK_TYPE(false, what, " dtype ", t.scalar_type(), "; takes float32 or bfloat16");
  return -1;
}

void* current_stream(const at::Device& device) {
  return c10::impl::getDeviceGuardImpl(device.type())->getStream(device).native_handle();
}

void check_launch(int err, const char* what) {
  TORCH_CHECK(err == 0, what, " launch failed: cudaError ", err);
}

// img (B, H, W, C) f32/bf16, coords (B, ..., 2) f32 -> (B, ..., C).
at::Tensor bilinear_sample(const at::Tensor& img, const at::Tensor& coords) {
  TORCH_CHECK_VALUE(img.is_cuda() && coords.is_cuda(), "B1 takes CUDA tensors only");
  TORCH_CHECK_VALUE(img.device() == coords.device(), "img on ", img.device(), ", coords on ",
                    coords.device());
  const int code = dtype_code(img, "B1 image");
  TORCH_CHECK_TYPE(coords.scalar_type() == at::kFloat, "B1 coords dtype ",
                   coords.scalar_type(), "; takes float32");
  TORCH_CHECK_VALUE(img.dim() == 4 && coords.dim() >= 2 && coords.size(-1) == 2 &&
                        coords.size(0) == img.size(0),
                    "B1 shapes img ", img.sizes(), ", coords ", coords.sizes());
  TORCH_CHECK_VALUE(img.is_contiguous() && coords.is_contiguous(),
                    "B1 takes contiguous img and coords");
  TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(coords.data_ptr()) % 8 == 0,
                    "B1 coords must be 8-byte aligned");
  const int64_t B = img.size(0), H = img.size(1), W = img.size(2), C = img.size(3);
  TORCH_CHECK_VALUE(B >= 1 && H >= 1 && W >= 1 && C >= 1, "B1 image shape ", img.sizes(),
                    " out of range");
  c10::SmallVector<int64_t, 8> shape(coords.sizes().begin(), coords.sizes().end() - 1);
  shape.push_back(C);
  c10::OptionalDeviceGuard guard(img.device());
  at::Tensor out = at::empty(shape, img.options());
  const int64_t Q = out.numel() / (B * C);
  if (Q == 0) return out;
  const int64_t vec = code == 0 ? 4 : 8;
  const int vector = C % vec == 0 && reinterpret_cast<uintptr_t>(img.data_ptr()) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out.data_ptr()) % 16 == 0;
  check_launch(dsfm_bilinear_sample(img.data_ptr(), coords.data_ptr(), out.data_ptr(), B, H, W,
                                    C, Q, code, vector, current_stream(img.device())),
               "B1");
  return out;
}

// The sweep kernels' common rules: CUDA tensors on one device, contiguous;
// the features of one dtype, float32 or bfloat16, 16-byte aligned, with rows
// of C channels a multiple of 16 bytes up to kMaxRowBytes; depths (D,),
// M (B, 3, 3), Kt (B, 3) float32, 4-byte aligned. Returns the dtype code.
int check_sweep_args(const char* what, std::initializer_list<at::Tensor> feats,
                     const at::Tensor& depths, const at::Tensor& M, const at::Tensor& Kt,
                     int64_t B, int64_t C) {
  const at::Tensor& first = *feats.begin();
  for (const at::Tensor* t : {&first, &depths, &M, &Kt})
    TORCH_CHECK_VALUE(t->is_cuda(), "the ", what, " takes CUDA tensors only");
  for (const at::Tensor& t : feats)
    TORCH_CHECK_VALUE(t.is_cuda() && t.device() == first.device(), what, " inputs on ",
                      t.device(), " and ", first.device());
  for (const at::Tensor* t : {&depths, &M, &Kt})
    TORCH_CHECK_VALUE(t->device() == first.device(), what, " inputs on ", t->device(),
                      " and ", first.device());
  const int code = dtype_code(first, what);
  for (const at::Tensor& t : feats)
    TORCH_CHECK_TYPE(t.scalar_type() == first.scalar_type(), what, " features of dtypes ",
                     t.scalar_type(), " and ", first.scalar_type());
  for (const at::Tensor* t : {&depths, &M, &Kt})
    TORCH_CHECK_TYPE(t->scalar_type() == at::kFloat, what, " depths, M and Kt must be float32");
  TORCH_CHECK_VALUE(depths.dim() == 1 && M.dim() == 3 && M.size(0) == B && M.size(1) == 3 &&
                        M.size(2) == 3 && Kt.dim() == 2 && Kt.size(0) == B && Kt.size(1) == 3,
                    what, " depths ", depths.sizes(), ", M ", M.sizes(), ", Kt ", Kt.sizes(),
                    " for B = ", B);
  for (const at::Tensor& t : feats)
    TORCH_CHECK_VALUE(t.is_contiguous(), "the ", what, " takes contiguous inputs");
  for (const at::Tensor* t : {&depths, &M, &Kt})
    TORCH_CHECK_VALUE(t->is_contiguous(), "the ", what, " takes contiguous inputs");
  const int64_t row = C * first.element_size();
  TORCH_CHECK_VALUE(row % 16 == 0 && row <= kMaxRowBytes, what, " feature rows of ", row,
                    " bytes; takes a multiple of 16 up to ", kMaxRowBytes);
  for (const at::Tensor& t : feats)
    TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, what,
                      " features must be 16-byte aligned");
  for (const at::Tensor* t : {&depths, &M, &Kt})
    TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(t->data_ptr()) % 4 == 0, what,
                      " depths, M, Kt must be 4-byte aligned");
  return code;
}

// ref, tgt (B, H, W, C); depths (D,), M (B, 3, 3), Kt (B, 3) f32 ->
// (B, D, H, W, 2C) [ref | warped] in the features' dtype.
at::Tensor plane_sweep_volume(const at::Tensor& ref, const at::Tensor& tgt,
                              const at::Tensor& depths, const at::Tensor& M,
                              const at::Tensor& Kt) {
  TORCH_CHECK_VALUE(ref.dim() == 4 && tgt.sizes() == ref.sizes(), "sweep shapes ref ",
                    ref.sizes(), ", tgt ", tgt.sizes());
  const int64_t B = ref.size(0), H = ref.size(1), W = ref.size(2), C = ref.size(3);
  const int code = check_sweep_args("sweep kernel", {ref, tgt}, depths, M, Kt, B, C);
  const int64_t D = depths.size(0);
  c10::OptionalDeviceGuard guard(ref.device());
  at::Tensor out = at::empty({B, D, H, W, 2 * C}, ref.options());
  if (out.numel() == 0) return out;
  check_launch(dsfm_plane_sweep_volume(ref.data_ptr(), tgt.data_ptr(), depths.data_ptr(),
                                       M.data_ptr(), Kt.data_ptr(), out.data_ptr(), B, D, H, W,
                                       C, code, current_stream(ref.device())),
               "sweep kernel");
  return out;
}

// dvol (B, D, H, W, 2C) -> (dref in dvol's dtype, dtgt float32, stats) under
// the work mapping (0: the kernel's default); stats (4,) int64 counts
// [shared groups, direct groups, samples that left their box, 16-byte
// global reductions] when `count` is set, and is empty otherwise.
std::tuple<at::Tensor, at::Tensor, at::Tensor> backward_launch(
    const at::Tensor& dvol, const at::Tensor& depths, const at::Tensor& M,
    const at::Tensor& Kt, int64_t tile_h, int64_t tile_w, int64_t planes, int64_t smem_bytes,
    bool count) {
  TORCH_CHECK_VALUE(dvol.dim() == 5 && dvol.size(-1) % 2 == 0 && depths.dim() == 1 &&
                        dvol.size(1) == depths.size(0),
                    "sweep backward dvol ", dvol.sizes(), ", depths ", depths.sizes());
  const int64_t B = dvol.size(0), D = dvol.size(1), H = dvol.size(2), W = dvol.size(3);
  const int64_t C = dvol.size(4) / 2;
  const int code = check_sweep_args("sweep backward", {dvol}, depths, M, Kt, B, C);
  c10::OptionalDeviceGuard guard(dvol.device());
  at::Tensor dref = at::empty({B, H, W, C}, dvol.options());
  at::Tensor acc = at::zeros({B, H, W, C}, dvol.options().dtype(at::kFloat));
  at::Tensor stats = at::zeros({int64_t(count ? 4 : 0)}, dvol.options().dtype(at::kLong));
  if (dvol.numel() == 0) return {dref.zero_(), acc, stats};
  check_launch(dsfm_plane_sweep_volume_backward_probe(
                   dvol.data_ptr(), depths.data_ptr(), M.data_ptr(), Kt.data_ptr(),
                   dref.data_ptr(), acc.data_ptr(), B, D, H, W, C, code, tile_h, tile_w,
                   planes, smem_bytes, count ? stats.data_ptr() : nullptr,
                   current_stream(dvol.device())),
               "sweep backward kernel");
  return {dref, acc, stats};
}

// dvol (B, D, H, W, 2C) -> (dref, dtgt), each (B, H, W, C) in dvol's
// dtype; dtgt is summed in a float32 buffer, then cast.
std::tuple<at::Tensor, at::Tensor> plane_sweep_volume_backward(const at::Tensor& dvol,
                                                               const at::Tensor& depths,
                                                               const at::Tensor& M,
                                                               const at::Tensor& Kt) {
  auto r = backward_launch(dvol, depths, M, Kt, 0, 0, 0, 0, false);
  return {std::get<0>(r), std::get<1>(r).to(dvol.scalar_type())};
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> plane_sweep_volume_backward_probe(
    const at::Tensor& dvol, const at::Tensor& depths, const at::Tensor& M,
    const at::Tensor& Kt, int64_t tile_h, int64_t tile_w, int64_t planes, int64_t smem_bytes) {
  return backward_launch(dvol, depths, M, Kt, tile_h, tile_w, planes, smem_bytes, true);
}

// dvol (B, D, H, W, 2C), tgt (B, H, W, C) of one dtype; depths, M, Kt as the
// forward took them -> (dM (B, 3, 3), dKt (B, 3)) float32. The partials are
// scratch, 12 doubles a block of the first pass.
std::tuple<at::Tensor, at::Tensor> plane_sweep_volume_pose_grad(const at::Tensor& dvol,
                                                                const at::Tensor& tgt,
                                                                const at::Tensor& depths,
                                                                const at::Tensor& M,
                                                                const at::Tensor& Kt) {
  TORCH_CHECK_VALUE(dvol.dim() == 5 && tgt.dim() == 4 && depths.dim() == 1 &&
                        dvol.size(0) == tgt.size(0) && dvol.size(1) == depths.size(0) &&
                        dvol.size(2) == tgt.size(1) && dvol.size(3) == tgt.size(2) &&
                        dvol.size(4) == 2 * tgt.size(3),
                    "sweep pose gradient dvol ", dvol.sizes(), ", tgt ", tgt.sizes(),
                    ", depths ", depths.sizes());
  const int64_t B = tgt.size(0), D = depths.size(0), H = tgt.size(1), W = tgt.size(2);
  const int64_t C = tgt.size(3);
  const int code = check_sweep_args("sweep pose gradient", {dvol, tgt}, depths, M, Kt, B, C);
  c10::OptionalDeviceGuard guard(dvol.device());
  at::Tensor dM = at::zeros({B, 3, 3}, M.options());
  at::Tensor dKt = at::zeros({B, 3}, Kt.options());
  if (dvol.numel() == 0) return {dM, dKt};
  const long long blocks = dsfm_plane_sweep_volume_pose_grad_blocks(B, D, H, W, C, code);
  TORCH_CHECK_VALUE(blocks > 0, "sweep pose gradient takes C * itemsize / 16 a power of two "
                    "up to 32 and H W < 2^27, got C = ", C, " of ", dvol.scalar_type(), ", H ",
                    H, ", W ", W);
  at::Tensor partial = at::empty({blocks, 12}, dvol.options().dtype(at::kDouble));
  check_launch(dsfm_plane_sweep_volume_pose_grad(
                   dvol.data_ptr(), tgt.data_ptr(), depths.data_ptr(), M.data_ptr(),
                   Kt.data_ptr(), partial.data_ptr(), dM.data_ptr(), dKt.data_ptr(), B, D, H,
                   W, C, code, current_stream(dvol.device())),
               "sweep pose gradient kernel");
  return {dM, dKt};
}

// The displacement volume's common rules: x, y (B, C, h, w) CUDA tensors on
// one device, contiguous, of one dtype, float32 or bfloat16, 1 <= C <= 64,
// h w < 2^24; md 0..4; flow None or a contiguous float32 (B, 2, h, w) on
// the same device (ops/cuda/sweep_warp.py::check_displacement_args).
// Returns the dtype code.
int check_displacement(const char* what, const at::Tensor& x, const at::Tensor& y,
                       const std::optional<at::Tensor>& flow, int64_t md) {
  TORCH_CHECK_VALUE(x.is_cuda() && y.is_cuda(), "the ", what, " takes CUDA tensors only");
  TORCH_CHECK_VALUE(y.device() == x.device(), what, " inputs on ", x.device(), " and ",
                    y.device());
  const int code = dtype_code(x, what);
  TORCH_CHECK_TYPE(y.scalar_type() == x.scalar_type(), what, " x and y of dtypes ",
                   x.scalar_type(), " and ", y.scalar_type());
  TORCH_CHECK_VALUE(x.dim() == 4 && y.sizes() == x.sizes(), what, " shapes x ", x.sizes(),
                    ", y ", y.sizes());
  const int64_t B = x.size(0), C = x.size(1), h = x.size(2), w = x.size(3);
  TORCH_CHECK_VALUE(B >= 1 && h >= 1 && w >= 1 && C >= 1 && C <= 64 && h * w < (1 << 24), what,
                    " x ", x.sizes(), "; takes 1 <= C <= 64 and h w < 2^24");
  TORCH_CHECK_VALUE(md >= 0 && md <= 4, what, " md ", md, "; takes 0 <= md <= 4");
  TORCH_CHECK_VALUE(x.is_contiguous() && y.is_contiguous(), "the ", what,
                    " takes contiguous x and y");
  if (flow.has_value()) {
    const at::Tensor& f = *flow;
    TORCH_CHECK_VALUE(f.is_cuda() && f.device() == x.device(), what, " flow on ", f.device());
    TORCH_CHECK_TYPE(f.scalar_type() == at::kFloat, what, " flow dtype ", f.scalar_type(),
                     "; takes float32");
    TORCH_CHECK_VALUE(f.dim() == 4 && f.size(0) == B && f.size(1) == 2 && f.size(2) == h &&
                          f.size(3) == w && f.is_contiguous(),
                      what, " flow ", f.sizes(), "; takes a contiguous (B, 2, h, w)");
  }
  return code;
}

// DICL's displacement volume: x, y (B, C, h, w) f32/bf16 NCHW, flow
// (B, 2, h, w) f32 or None, md, and the work mapping of
// ops/cuda/sweep_warp.py::displacement_plan (vec_bytes, tile_w, band_h,
// fused, grid; the launcher refuses one the kernel cannot run) ->
// (B, (2md+1)^2, 2C, h, w) in x's dtype.
at::Tensor displacement_volume(const at::Tensor& x, const at::Tensor& y,
                               const std::optional<at::Tensor>& flow, int64_t md,
                               int64_t vec_bytes, int64_t tile_w, int64_t band_h,
                               int64_t fused, int64_t grid) {
  const int code = check_displacement("displacement volume", x, y, flow, md);
  const int64_t B = x.size(0), C = x.size(1), h = x.size(2), w = x.size(3);
  const int64_t S = 2 * md + 1;
  TORCH_CHECK_VALUE(vec_bytes > 0 && tile_w > 0 && band_h > 0 && grid > 0 &&
                        grid < (1 << 30) && tile_w < (1 << 20),
                    "displacement volume plan ", vec_bytes, ", ", tile_w, ", ", band_h, ", ",
                    grid);
  c10::OptionalDeviceGuard guard(x.device());
  at::Tensor out = at::empty({B, S * S, 2 * C, h, w}, x.options());
  check_launch(dsfm_displacement_volume(x.data_ptr(), y.data_ptr(),
                                        flow.has_value() ? flow->data_ptr() : nullptr,
                                        out.data_ptr(), B, C, h, w, md, code, vec_bytes, tile_w,
                                        band_h, fused, grid, current_stream(x.device())),
               "displacement volume kernel");
  return out;
}

// The displacement volume's backward: dout (B, (2md+1)^2, 2C, h, w) and y
// (B, C, h, w) of one dtype, flow (B, 2, h, w) f32 or None, md, as the
// forward took them -> (dx, dy), each (B, C, h, w) in dout's dtype. With a
// flow, dy is summed in a float32 buffer that the launch zeroes and, in
// bfloat16, casts into dy; in float32 the buffer is dy. The forward's rules,
// and dout contiguous of the forward's output shape.
std::tuple<at::Tensor, at::Tensor> displacement_volume_backward(
    const at::Tensor& dout, const at::Tensor& y, const std::optional<at::Tensor>& flow,
    int64_t md) {
  const char* what = "displacement volume backward";
  const int code = check_displacement(what, y, y, flow, md);
  const int64_t B = y.size(0), C = y.size(1), h = y.size(2), w = y.size(3);
  const int64_t S = 2 * md + 1;
  TORCH_CHECK_VALUE(dout.is_cuda() && dout.device() == y.device(), what, " dout on ",
                    dout.device());
  TORCH_CHECK_TYPE(dout.scalar_type() == y.scalar_type(), what, " dout and y of dtypes ",
                   dout.scalar_type(), " and ", y.scalar_type());
  TORCH_CHECK_VALUE(dout.dim() == 5 && dout.size(0) == B && dout.size(1) == S * S &&
                        dout.size(2) == 2 * C && dout.size(3) == h && dout.size(4) == w &&
                        dout.is_contiguous(),
                    what, " dout ", dout.sizes(), "; takes a contiguous (", B, ", ", S * S,
                    ", ", 2 * C, ", ", h, ", ", w, ")");
  c10::OptionalDeviceGuard guard(y.device());
  at::Tensor dx = at::empty({B, C, h, w}, y.options());
  const bool warped = flow.has_value();
  at::Tensor acc = warped ? at::empty({B, C, h, w}, y.options().dtype(at::kFloat)) : at::Tensor();
  at::Tensor dy = warped && code == 0 ? acc : at::empty({B, C, h, w}, y.options());
  check_launch(dsfm_displacement_volume_backward(
                   dout.data_ptr(), y.data_ptr(), warped ? flow->data_ptr() : nullptr,
                   dx.data_ptr(), dy.data_ptr(), warped ? acc.data_ptr() : nullptr, B, C, h, w,
                   md, code, current_stream(y.device())),
               "displacement volume backward kernel");
  return {dx, dy};
}

}  // namespace

TORCH_LIBRARY(dsfm, m) {
  m.def("bilinear_sample(Tensor img, Tensor coords) -> Tensor");
  m.def("plane_sweep_volume(Tensor ref, Tensor tgt, Tensor depths, Tensor M, Tensor Kt) -> Tensor");
  m.def("plane_sweep_volume_backward(Tensor dvol, Tensor depths, Tensor M, Tensor Kt) -> "
        "(Tensor, Tensor)");
  m.def("plane_sweep_volume_backward_probe(Tensor dvol, Tensor depths, Tensor M, Tensor Kt, "
        "int tile_h, int tile_w, int planes, int smem_bytes) -> (Tensor, Tensor, Tensor)");
  m.def("plane_sweep_volume_pose_grad(Tensor dvol, Tensor tgt, Tensor depths, Tensor M, "
        "Tensor Kt) -> (Tensor, Tensor)");
  m.def("displacement_volume(Tensor x, Tensor y, Tensor? flow, int md, int vec_bytes, "
        "int tile_w, int band_h, int fused, int grid) -> Tensor");
  m.def("displacement_volume_backward(Tensor dout, Tensor y, Tensor? flow, int md) -> "
        "(Tensor, Tensor)");
}

// Registered for every dispatch key: a CPU tensor reaches the checks, which
// refuse it, as the ctypes wrappers did.
TORCH_LIBRARY_IMPL(dsfm, CompositeExplicitAutograd, m) {
  m.impl("bilinear_sample", &bilinear_sample);
  m.impl("plane_sweep_volume", &plane_sweep_volume);
  m.impl("plane_sweep_volume_backward", &plane_sweep_volume_backward);
  m.impl("plane_sweep_volume_backward_probe", &plane_sweep_volume_backward_probe);
  m.impl("plane_sweep_volume_pose_grad", &plane_sweep_volume_pose_grad);
  m.impl("displacement_volume", &displacement_volume);
  m.impl("displacement_volume_backward", &displacement_volume_backward);
}
