// The CUDA kernels of the operators whose schemas, CPU and Meta kernels are
// egonet_ops.cpp's.  egonet::fused_basic_block and
// egonet::fused_basic_block_stencil: check the operands, take the width's
// default plan (the stencil: the plan it is given, if any) and launch the
// Hopper kernel of fused_basic_block.cu / fused_basic_block_stencil.cu
// through its plain C entry point.  Where the tiled plan has a cluster,
// the weights' TMA descriptors go with the launch, each encoded once per
// (device, address, width) and kept.
// egonet::rigid_solve: check the operand and launch rigid_solve.cu's one
// kernel over the batch.  egonet::bn_act: check the operands and launch
// bn_act.cu's one pass over the tensor.  Each on the current stream of its
// input's device with that device current.
//
// Host C++ only, built by ops/_build.py with the host compiler against
// torch's headers (c10/cuda for the device guard and the stream) and
// linked against libegonet_ops.so (the launch counts) and the kernel
// libraries (the two default fused-block libraries, librigid_solve.so and
// libbn_act.so),
// found beside it through the rpath $ORIGIN.  The kernel sources stay free
// of torch's headers, so their nvcc builds take seconds.
//
// The plans are defined once, in Python (plan_for / takes of
// ops/fused_block.py and ops/fused_block_stencil.py): ops/_build.py writes
// them into this library's prelude as X-macros, the plan structs' fields
// (EGONET_*_FIELDS, the kernels' Plan / StencilPlan in the same order) and
// every width's default plan (EGONET_*_PLANS), and a changed table
// rebuilds the library.  A plan given to the stencil op comes as its fields
// in that order (ops/fused_block_stencil.py, _PLAN_FIELDS).

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <optional>
#include <set>
#include <sstream>
#include <string>
#include <tuple>
#include <utility>
#include <vector>

#include "egonet_ops.h"

#if !defined(EGONET_TILED_PLANS) || !defined(EGONET_STENCIL_PLANS)
#error "the plan table is undefined: build through egonet_tpu_torch/ops/_build.py"
#endif

#define EGONET_FIELD(f) int f;
struct TiledPlan {
  EGONET_TILED_FIELDS(EGONET_FIELD)
};
struct StencilPlan {
  EGONET_STENCIL_FIELDS(EGONET_FIELD)
};
#undef EGONET_FIELD
#define EGONET_COUNT(f) +1
constexpr size_t kStencilFields = 0 EGONET_STENCIL_FIELDS(EGONET_COUNT);
#undef EGONET_COUNT

extern "C" {
// fused_basic_block.cu / fused_basic_block_stencil.cu: 0 or a cudaError_t
int egonet_fused_basic_block(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* y, int N,
                             int H, int W, int C, TiledPlan p,
                             const void* map1, const void* map2,
                             void* stream);
// 0 or a CUresult
int egonet_fused_basic_block_weight_map(const void* w, int C, TiledPlan p,
                                        void* map);
int egonet_fused_basic_block_clusters(int C, TiledPlan p, int* clusters);
int egonet_fused_basic_block_stencil(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* y, int N, int H,
                                     int W, int C, StencilPlan p,
                                     void* stream);
int egonet_fused_basic_block_stencil_clusters(int C, StencilPlan p,
                                              int* clusters);
// rigid_solve.cu: 0 or a cudaError_t
int egonet_rigid_solve(const float* kpts, float* out, int n, int p,
                       void* stream);
// bn_act.cu: 0 or a cudaError_t
int egonet_bn_act(const void* x, int64_t x_stride, const float* scale,
                  const float* shift, const void* residual, int64_t r_stride,
                  void* y, int64_t pixels, int c, int relu, void* stream);
}

namespace {

template <typename Plan>
struct Entry {
  int c;
  Plan plan;
};

#define EGONET_ENTRY(c, ...) {c, {__VA_ARGS__}},
const Entry<TiledPlan> kTiled[] = {EGONET_TILED_PLANS(EGONET_ENTRY)};
const Entry<StencilPlan> kStencil[] = {EGONET_STENCIL_PLANS(EGONET_ENTRY)};
#undef EGONET_ENTRY

template <typename Plan, size_t N>
const Plan& plan_for(const Entry<Plan> (&table)[N], int64_t c,
                     const char* op) {
  for (const Entry<Plan>& e : table) {
    if (e.c == c) return e.plan;
  }
  TORCH_CHECK_VALUE(false, op, ": the default library serves no plan at C=",
                    c, " (ops/fused_block*.py takes(c))");
}

std::string describe(const TiledPlan& p) {
  std::ostringstream s;
#define EGONET_SHOW(f) s << " " #f "=" << p.f;
  EGONET_TILED_FIELDS(EGONET_SHOW)
#undef EGONET_SHOW
  return s.str();
}

std::string describe(const StencilPlan& p) {
  std::ostringstream s;
#define EGONET_SHOW(f) s << " " #f "=" << p.f;
  EGONET_STENCIL_FIELDS(EGONET_SHOW)
#undef EGONET_SHOW
  return s.str();
}

// The stencil's plan: the fields `given`, else the width's default.
StencilPlan stencil_plan(int64_t c, at::OptionalIntArrayRef given) {
  if (!given.has_value()) {
    return plan_for(kStencil, c, "fused_basic_block_stencil");
  }
  TORCH_CHECK_VALUE(given->size() == kStencilFields,
                    "fused_basic_block_stencil: a plan has ", kStencilFields,
                    " fields (_PLAN_FIELDS), got ", given->size());
  StencilPlan p;
  const int64_t* f = given->data();
#define EGONET_SET(name) p.name = int(*f++);
  EGONET_STENCIL_FIELDS(EGONET_SET)
#undef EGONET_SET
  return p;
}

// The error's text, as torch's CUDA runtime names it.
std::string cuda_error(int err) {
  try {
    c10::cuda::c10_cuda_check_implementation(err, __FILE__, __func__,
                                             __LINE__, false);
  } catch (const c10::Error& e) {
    const std::string what = e.what_without_backtrace();
    return "CUDA error " + std::to_string(err) + " (" +
           what.substr(0, what.find('\n')) + ")";
  }
  return "no CUDA error";
}

// The contract, then 32-byte alignment.
void check(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& b1,
           const at::Tensor& w2, const at::Tensor& b2, egonet::Op op) {
  egonet::check_contract(x, w1, b1, w2, b2, op);
  for (const at::Tensor* t : {&x, &w1, &b1, &w2, &b2}) {
    TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(t->data_ptr()) % 32 == 0,
                      "operands must be 32-byte aligned");
  }
}

#define EGONET_VALUE(f) p.f,
std::vector<int> values(const TiledPlan& p) {
  return {EGONET_TILED_FIELDS(EGONET_VALUE)};
}
std::vector<int> values(const StencilPlan& p) {
  return {EGONET_STENCIL_FIELDS(EGONET_VALUE)};
}
#undef EGONET_VALUE

int clusters_of(int64_t c, const TiledPlan& p, int* n) {
  return egonet_fused_basic_block_clusters(int(c), p, n);
}
int clusters_of(int64_t c, const StencilPlan& p, int* n) {
  return egonet_fused_basic_block_stencil_clusters(int(c), p, n);
}

// A clustered plan's occupancy check (k blocks a cluster), once per device
// and plan: a launch of a plan the card holds no cluster of would fail.
template <typename Plan>
void check_clusters(int device, int64_t c, const Plan& p, int k) {
  static std::mutex mu;
  static std::set<std::pair<int, std::vector<int>>> held;
  const std::pair<int, std::vector<int>> key{device, values(p)};
  const std::lock_guard<std::mutex> lock(mu);
  if (held.count(key)) return;
  int clusters = 0;
  const int err = clusters_of(c, p, &clusters);
  TORCH_CHECK(err == 0, "cluster occupancy query failed: ", cuda_error(err),
              " (C=", c, describe(p), ")");
  TORCH_CHECK(clusters >= 1, "the card holds no cluster of ", k,
              " blocks of ", p.smem, " bytes (C=", c, describe(p), ")");
  held.insert(key);
}

// A CUtensorMap (128 bytes, 64-byte aligned), opaque here.
struct alignas(64) WeightMap {
  unsigned char bytes[128];
};

// The TMA descriptor of the weight `w` for the tiled cluster plan `p` at
// width c, encoded at the first launch that reads it and kept per
// (device, address, width): it holds nothing but the address and the
// width's box, so a tensor later allocated at the same address takes the
// same one.  The kept set is emptied past 4,096 descriptors.
WeightMap weight_map(int device, const at::Tensor& w, int64_t c,
                     const TiledPlan& p) {
  using Key = std::tuple<int, const void*, int64_t>;
  static std::mutex mu;
  static std::map<Key, WeightMap> kept;
  const Key key{device, w.data_ptr(), c};
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = kept.find(key);
  if (it != kept.end()) return it->second;
  WeightMap m{};
  const int err =
      egonet_fused_basic_block_weight_map(w.data_ptr(), int(c), p, &m);
  TORCH_CHECK(err == 0, "fused_basic_block: the weights' TMA descriptor "
              "could not be encoded (CUresult ", err, "; C=", c, describe(p),
              ")");
  if (kept.size() >= 4096) kept.clear();
  kept.emplace(key, m);
  return m;
}

template <egonet::Op OP>
at::Tensor fused_cuda(const at::Tensor& x, const at::Tensor& w1,
                      const at::Tensor& b1, const at::Tensor& w2,
                      const at::Tensor& b2, at::OptionalIntArrayRef given) {
  const char* name =
      OP == egonet::kTiled ? "fused_basic_block" : "fused_basic_block_stencil";
  check(x, w1, b1, w2, b2, OP);
  const c10::cuda::CUDAGuard guard(x.device());
  const int n = int(x.size(0)), h = int(x.size(1)), w = int(x.size(2)),
            c = int(x.size(3));
  at::Tensor y = at::empty_like(x);
  void* stream = c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
  int err;
  std::string plan;
  bool clustered = false;
  if constexpr (OP == egonet::kTiled) {
    const TiledPlan& p = plan_for(kTiled, c, name);
    clustered = p.cluster > 1;
    WeightMap m1, m2;
    if (clustered) {
      const int device = x.device().index();
      check_clusters(device, c, p, p.cluster);
      m1 = weight_map(device, w1, c, p);
      m2 = weight_map(device, w2, c, p);
    }
    err = egonet_fused_basic_block(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), n, h, w, c, p,
        clustered ? &m1 : nullptr, clustered ? &m2 : nullptr, stream);
    if (err != 0) plan = describe(p);
  } else {
    const StencilPlan p = stencil_plan(c, given);
    check_clusters(x.device().index(), c, p, p.k);
    err = egonet_fused_basic_block_stencil(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), n, h, w, c, p, stream);
    if (err != 0) plan = describe(p);
  }
  TORCH_CHECK(err == 0, name, " launch failed: ", cuda_error(err), " (N=", n,
              " H=", h, " W=", w, " C=", c, " plan:", plan, ")");
  egonet_add_launch(OP);
  if (clustered) egonet_add_launch(egonet::kTiledMulticast);
  return y;
}

at::Tensor tiled_cuda(const at::Tensor& x, const at::Tensor& w1,
                      const at::Tensor& b1, const at::Tensor& w2,
                      const at::Tensor& b2) {
  return fused_cuda<egonet::kTiled>(x, w1, b1, w2, b2, std::nullopt);
}

at::Tensor rigid_solve_cuda(const at::Tensor& kpts) {
  egonet::check_rigid(kpts);
  const c10::cuda::CUDAGuard guard(kpts.device());
  const int n = int(kpts.size(0)), p = int(kpts.size(1));
  at::Tensor out = at::empty({kpts.size(0), 6}, kpts.options());
  if (n == 0) return out;
  void* stream =
      c10::cuda::getCurrentCUDAStream(kpts.device().index()).stream();
  const int err = egonet_rigid_solve(kpts.const_data_ptr<float>(),
                                     out.mutable_data_ptr<float>(), n, p,
                                     stream);
  TORCH_CHECK(err == 0, "rigid_solve launch failed: ", cuda_error(err),
              " (N=", n, " P=", p, ")");
  egonet_add_launch(egonet::kRigid);
  return out;
}

at::Tensor bn_act_cuda(const at::Tensor& x, const at::Tensor& scale,
                       const at::Tensor& shift,
                       const std::optional<at::Tensor>& residual, bool relu) {
  egonet::check_bn_act(x, scale, shift, residual);
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor y = at::empty(x.sizes(), x.options());
  const int64_t c = x.size(3);
  if (x.numel() == 0) return y;
  void* stream = c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
  const int err = egonet_bn_act(
      x.const_data_ptr(), egonet::bn_act_pixel_stride(x).expect_int(),
      scale.const_data_ptr<float>(), shift.const_data_ptr<float>(),
      residual.has_value() ? residual->const_data_ptr() : nullptr,
      residual.has_value()
          ? egonet::bn_act_pixel_stride(*residual).expect_int()
          : c,
      y.mutable_data_ptr(), x.numel() / c, int(c), relu ? 1 : 0, stream);
  TORCH_CHECK(err == 0, "bn_act launch failed: ", cuda_error(err), " (sizes ",
              x.sizes(), ")");
  egonet_add_launch(egonet::kBnAct);
  return y;
}

}  // namespace

TORCH_LIBRARY_IMPL(egonet, CUDA, m) {
  m.impl("fused_basic_block", &tiled_cuda);
  m.impl("fused_basic_block_stencil", &fused_cuda<egonet::kStencil>);
  m.impl("rigid_solve", &rigid_solve_cuda);
  m.impl("bn_act", &bn_act_cuda);
}
