// The port's hand-written kernels as torch operators, defined once, in C++:
//
//   egonet::fused_basic_block(Tensor x, Tensor w1, Tensor b1, Tensor w2,
//                             Tensor b2) -> Tensor
//   egonet::fused_basic_block_stencil(<the same>, int[]? plan=None)
//                                     -> Tensor
//   egonet::rigid_solve(Tensor kpts_3d) -> Tensor
//   egonet::bn_act(Tensor x, Tensor scale, Tensor shift,
//                  Tensor? residual=None, bool relu=False) -> Tensor
//
// The first two: y = relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2 + x)
// on NHWC operands, batch norm folded (ops/fused_block.py); the stencil's
// plan, when given, picks the card's launch, not the function, so its CPU
// and Meta kernels ignore it.  The third: the
// facade's rigid stage, [N, P, 3] fp32 points -> [N, 6] (rx, ry, rz, tx,
// ty, tz) (ops/rigid_solve.py, csrc/rigid_solve.cuh).  The fourth: an
// inference batch norm's affine, an optional residual add and an optional
// relu on an NHWC bf16 tensor in one pass (ops/bn_act.py, csrc/bn_act.cuh).
// This library holds the schemas, the CPU kernels (the plain version of the
// blocks; the rigid solve's per-crop routine and bn_act's per-element one
// in loops, the arithmetic the card runs) and
// the Meta kernels (the contract, for torch.export and fake tensors), plus
// the launch counts.  libegonet_ops_cuda.so adds the CUDA kernels.  Both
// load with torch.ops.load_library and nothing else: an exported program
// that holds these ops runs from torch and the libraries alone
// (io/export.py).
//
// Built by ops/_build.py with the host C++ compiler against the installed
// torch's headers and libraries (c10, torch_cpu); it includes
// torch/library.h and ATen's headers only, never torch/extension.h.

#include <ATen/Parallel.h>
#include <ATen/TensorOperators.h>
#include <ATen/core/Tensor.h>
#include <ATen/ops/conv2d.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/relu.h>
#include <torch/library.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <optional>

#include "bn_act.cuh"
#include "egonet_ops.h"
#include "rigid_solve.cuh"

namespace {

std::atomic<int64_t> g_launches[egonet::kOps];

bool valid(int op) { return op >= 0 && op < egonet::kOps; }

// ops/fused_block.py (fused_basic_block_reference) in ATen: the same ops in
// the same order, so the two agree bit for bit.  fp32 convolutions on the
// permuted NHWC operands; the bias, then relu; mid rounded to bf16 when x
// is bf16; the second conv, its bias and the residual, then relu; the
// result in x's dtype.
at::Tensor plain(const at::Tensor& x, const at::Tensor& w1,
                 const at::Tensor& b1, const at::Tensor& w2,
                 const at::Tensor& b2) {
  const int64_t c = x.size(-1);
  const auto conv = [c](const at::Tensor& h, const at::Tensor& w) {
    const at::Tensor oihw =
        w.reshape({c, 3, 3, c}).to(at::kFloat).permute({0, 3, 1, 2});
    return at::conv2d(h.permute({0, 3, 1, 2}), oihw, {}, 1, 1)
        .permute({0, 2, 3, 1});
  };
  const at::Tensor xf = x.to(at::kFloat);
  at::Tensor mid = at::relu(conv(xf, w1) + b1.to(at::kFloat).reshape(-1));
  if (x.scalar_type() == at::kBFloat16) {
    mid = mid.to(at::kBFloat16).to(at::kFloat);
  }
  const at::Tensor y =
      at::relu(conv(mid, w2) + b2.to(at::kFloat).reshape(-1) + xf);
  return y.to(x.scalar_type());
}

template <egonet::Op OP>
at::Tensor meta(const at::Tensor& x, const at::Tensor& w1,
                const at::Tensor& b1, const at::Tensor& w2,
                const at::Tensor& b2) {
  egonet::check_contract(x, w1, b1, w2, b2, OP);
  return at::empty_like(x);
}

at::Tensor plain_stencil(const at::Tensor& x, const at::Tensor& w1,
                         const at::Tensor& b1, const at::Tensor& w2,
                         const at::Tensor& b2, at::OptionalIntArrayRef) {
  return plain(x, w1, b1, w2, b2);
}

at::Tensor meta_stencil(const at::Tensor& x, const at::Tensor& w1,
                        const at::Tensor& b1, const at::Tensor& w2,
                        const at::Tensor& b2, at::OptionalIntArrayRef) {
  return meta<egonet::kStencil>(x, w1, b1, w2, b2);
}

at::Tensor rigid_solve_cpu(const at::Tensor& kpts) {
  egonet::check_rigid(kpts);
  const int64_t n = kpts.size(0), p = kpts.size(1);
  at::Tensor out = at::empty({n, 6}, kpts.options());
  const float* in = kpts.const_data_ptr<float>();
  float* o = out.mutable_data_ptr<float>();
  for (int64_t i = 0; i < n; ++i) {
    egonet::rigid_solve_one(in + i * p * 3, int(p), o + i * 6);
  }
  return out;
}

at::Tensor rigid_solve_meta(const at::Tensor& kpts) {
  egonet::check_rigid(kpts);
  return at::empty_symint({kpts.sym_size(0), 6}, kpts.options());
}

template <bool RES, bool RELU>
void bn_act_rows(const uint16_t* x, int64_t xs, const float* scale,
                 const float* shift, const uint16_t* res, int64_t rs,
                 uint16_t* y, int64_t begin, int64_t end, int64_t c) {
  for (int64_t p = begin; p < end; ++p) {
    const uint16_t* xp = x + p * xs;
    const uint16_t* rp = RES ? res + p * rs : nullptr;
    uint16_t* yp = y + p * c;
    for (int64_t ch = 0; ch < c; ++ch) {
      yp[ch] = egonet::bn::one<RES, RELU>(xp[ch], scale[ch], shift[ch],
                                          RES ? rp[ch] : uint16_t(0));
    }
  }
}

at::Tensor bn_act_cpu(const at::Tensor& x, const at::Tensor& scale,
                      const at::Tensor& shift,
                      const std::optional<at::Tensor>& residual, bool relu) {
  egonet::check_bn_act(x, scale, shift, residual);
  at::Tensor y = at::empty(x.sizes(), x.options());
  const int64_t c = x.size(3), pixels = x.numel() / std::max<int64_t>(c, 1);
  const int64_t xs = egonet::bn_act_pixel_stride(x).expect_int();
  const int64_t rs = residual.has_value()
                         ? egonet::bn_act_pixel_stride(*residual).expect_int()
                         : c;
  const auto* xp = static_cast<const uint16_t*>(x.const_data_ptr());
  const auto* rp = residual.has_value()
                       ? static_cast<const uint16_t*>(residual->const_data_ptr())
                       : nullptr;
  auto* yp = static_cast<uint16_t*>(y.mutable_data_ptr());
  const float* sc = scale.const_data_ptr<float>();
  const float* sh = shift.const_data_ptr<float>();
  const auto rows = rp != nullptr ? (relu ? &bn_act_rows<true, true>
                                          : &bn_act_rows<true, false>)
                                  : (relu ? &bn_act_rows<false, true>
                                          : &bn_act_rows<false, false>);
  const int64_t grain = std::max<int64_t>(1, 32768 / std::max<int64_t>(c, 1));
  at::parallel_for(0, pixels, grain, [&](int64_t begin, int64_t end) {
    rows(xp, xs, sc, sh, rp, rs, yp, begin, end, c);
  });
  return y;
}

at::Tensor bn_act_meta(const at::Tensor& x, const at::Tensor& scale,
                       const at::Tensor& shift,
                       const std::optional<at::Tensor>& residual, bool relu) {
  egonet::check_bn_act(x, scale, shift, residual);
  return at::empty_symint(x.sym_sizes(), x.options());
}

}  // namespace

// called through ctypes too, so they throw nothing: an unknown op reads -1
extern "C" {

int64_t egonet_launches(int op) {
  return valid(op) ? g_launches[op].load() : -1;
}

void egonet_set_launches(int op, int64_t n) {
  if (valid(op)) g_launches[op].store(n);
}

void egonet_add_launch(int op) {
  if (valid(op)) g_launches[op].fetch_add(1);
}

}  // extern "C"

TORCH_LIBRARY(egonet, m) {
  m.def(
      "fused_basic_block(Tensor x, Tensor w1, Tensor b1, Tensor w2, "
      "Tensor b2) -> Tensor");
  m.def(
      "fused_basic_block_stencil(Tensor x, Tensor w1, Tensor b1, Tensor w2, "
      "Tensor b2, int[]? plan=None) -> Tensor");
  m.def("rigid_solve(Tensor kpts_3d) -> Tensor");
  m.def(
      "bn_act(Tensor x, Tensor scale, Tensor shift, Tensor? residual=None, "
      "bool relu=False) -> Tensor");
}

TORCH_LIBRARY_IMPL(egonet, CPU, m) {
  m.impl("fused_basic_block", &plain);
  m.impl("fused_basic_block_stencil", &plain_stencil);
  m.impl("rigid_solve", &rigid_solve_cpu);
  m.impl("bn_act", &bn_act_cpu);
}

TORCH_LIBRARY_IMPL(egonet, Meta, m) {
  m.impl("fused_basic_block", &meta<egonet::kTiled>);
  m.impl("fused_basic_block_stencil", &meta_stencil);
  m.impl("rigid_solve", &rigid_solve_meta);
  m.impl("bn_act", &bn_act_meta);
}
