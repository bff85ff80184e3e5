// Shared by egonet_ops.cpp (the operators' schemas, CPU and Meta kernels)
// and egonet_ops_cuda.cpp (their CUDA kernels): the operands' contract and
// the launch counts.  Host C++ against torch's headers; no CUDA here.
#pragma once

#include <ATen/core/Tensor.h>
#include <c10/util/Exception.h>

#include <cstdint>

extern "C" {
// Kernel launches of op `op` (kTiled, kStencil or kRigid), counted by
// libegonet_ops.so where a kernel launches: the CUDA kernels of
// egonet_ops_cuda.cpp and the direct launches of ops/fused_block*.py
// (ctypes), and nowhere else.
int64_t egonet_launches(int op);
void egonet_set_launches(int op, int64_t n);
void egonet_add_launch(int op);
}

namespace egonet {

enum Op : int { kTiled = 0, kStencil = 1, kRigid = 2, kOps = 3 };

// the widest channel count the stencil kernel's default library serves
// (ops/fused_block_stencil.py, _MAX_C), from the prelude ops/_build.py
// writes for both operator libraries
#ifndef EGONET_STENCIL_MAX_C
#error "EGONET_STENCIL_MAX_C is undefined: build through egonet_tpu_torch/ops/_build.py"
#endif
constexpr int64_t kStencilMaxC = EGONET_STENCIL_MAX_C;

// The checks of ops/fused_block.py (_check_shapes), and for the stencil
// its C <= 384, in the same order and with the same messages: they need
// no data, so the Meta kernels run them under torch.export, where sizes
// may be symbolic (a comparison guards on them).  ValueError, as the
// Python checks raised.
inline void check_contract(const at::Tensor& x, const at::Tensor& w1,
                           const at::Tensor& b1, const at::Tensor& w2,
                           const at::Tensor& b2, Op op) {
  TORCH_CHECK_VALUE(
      x.scalar_type() == at::kBFloat16 && x.dim() == 4 && x.is_contiguous(),
      "x must be a contiguous NHWC bf16 tensor, got ", x.scalar_type(), " ",
      x.sym_sizes());
  const c10::SymInt c = x.sym_size(3);
  TORCH_CHECK_VALUE(c % 16 == 0, "channel width ", c,
                    " is not a multiple of 16");
  const auto weight = [&](const char* name, const at::Tensor& w) {
    TORCH_CHECK_VALUE(w.scalar_type() == at::kBFloat16 &&
                          w.sym_numel() == 9 * c * c &&
                          w.sym_size(0) == c && w.is_contiguous(),
                      name, " must be contiguous bf16 [C, 3, 3, C]");
  };
  const auto bias = [&](const char* name, const at::Tensor& b) {
    TORCH_CHECK_VALUE(b.scalar_type() == at::kFloat && b.sym_numel() == c &&
                          b.is_contiguous(),
                      name, " must be contiguous fp32 [C]");
  };
  weight("w1", w1);
  weight("w2", w2);
  bias("b1", b1);
  bias("b2", b2);
  for (const at::Tensor* t : {&w1, &b1, &w2, &b2}) {
    TORCH_CHECK_VALUE(t->device() == x.device(),
                      "all operands must be on x's device");
  }
  if (op == kStencil) {
    TORCH_CHECK_VALUE(c <= kStencilMaxC, "the stencil kernel takes C <= ",
                      kStencilMaxC, ", got ", c);
  }
}

// egonet::rigid_solve's operand (ops/rigid_solve.py): contiguous fp32
// [N, P, 3] with P = 32 or 33, checked without data for the Meta kernel.
inline void check_rigid(const at::Tensor& kpts) {
  TORCH_CHECK_VALUE(kpts.scalar_type() == at::kFloat && kpts.dim() == 3 &&
                        kpts.is_contiguous(),
                    "kpts_3d must be a contiguous fp32 [N, P, 3] tensor, got ",
                    kpts.scalar_type(), " ", kpts.sym_sizes());
  const c10::SymInt p = kpts.sym_size(1);
  TORCH_CHECK_VALUE(kpts.sym_size(2) == 3 && (p == 32 || p == 33),
                    "kpts_3d must hold 32 or 33 points of 3 coordinates, got ",
                    kpts.sym_sizes());
}

}  // namespace egonet
