// Shared by egonet_ops.cpp (the operators' schemas, CPU and Meta kernels)
// and egonet_ops_cuda.cpp (their CUDA kernels): the operands' contract and
// the launch counts.  Host C++ against torch's headers; no CUDA here.
#pragma once

#include <ATen/core/Tensor.h>
#include <c10/util/Exception.h>

#include <cstdint>
#include <optional>

extern "C" {
// Kernel launches of op `op` (kTiled, kStencil, kRigid or kBnAct; and
// kTiledMulticast, the tiled op's launches as clusters sharing each weight
// slab, counted besides kTiled), counted by libegonet_ops.so where a kernel
// launches, in the CUDA kernels of egonet_ops_cuda.cpp, and nowhere else.
// ops/_build.py reads and sets them through ctypes.
int64_t egonet_launches(int op);
void egonet_set_launches(int op, int64_t n);
void egonet_add_launch(int op);
}

namespace egonet {

enum Op : int {
  kTiled = 0,
  kStencil = 1,
  kRigid = 2,
  kBnAct = 3,
  kTiledMulticast = 4,
  kOps = 5
};

// the widest channel count the stencil kernel's default library serves
// (ops/fused_block_stencil.py, _MAX_C), from the prelude ops/_build.py
// writes for both operator libraries
#ifndef EGONET_STENCIL_MAX_C
#error "EGONET_STENCIL_MAX_C is undefined: build through egonet_tpu_torch/ops/_build.py"
#endif
constexpr int64_t kStencilMaxC = EGONET_STENCIL_MAX_C;

// The fused blocks' operand contract, and for the stencil its C <= 384,
// run by the Meta and CUDA kernels (the CPU kernel, the plain version, also
// takes fp32 operands): the checks need no data, so the Meta kernels run
// them under torch.export, where sizes may be symbolic (a comparison guards
// on them).  ValueError, as the wrappers' callers expect.
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

// The distance in elements between neighbouring pixels of an [N, H, W, C]
// tensor whose channels are adjacent and whose pixels lie at one step of
// at least C (a channels_last NCHW tensor permuted: C; a channel slice of
// one, as fuse_merge's split of a merged conv gives: the whole width), or
// -1 for any other layout.  Strides of size-1 dimensions are not read.
inline c10::SymInt bn_act_pixel_stride(const at::Tensor& t) {
  const auto sizes = t.sym_sizes();
  const auto strides = t.sym_strides();
  if (sizes[3] != 1 && strides[3] != 1) return -1;
  c10::SymInt step = sizes[3];
  for (int d = 2; d >= 0; --d) {
    if (sizes[d] != 1) {
      step = strides[d];
      break;
    }
  }
  if (step < sizes[3]) return -1;
  c10::SymInt span = step;
  for (int d = 2; d >= 0; --d) {
    if (sizes[d] != 1 && strides[d] != span) return -1;
    span = span * sizes[d];
  }
  return step;
}

// egonet::bn_act's operands (ops/bn_act.py): x bf16 [N, H, W, C] of the
// layout bn_act_pixel_stride reads, scale and shift contiguous fp32 [C],
// the residual (if any) bf16 of x's sizes and of such a layout, all on x's
// device; checked without data for the Meta kernel.
inline void check_bn_act(const at::Tensor& x, const at::Tensor& scale,
                         const at::Tensor& shift,
                         const std::optional<at::Tensor>& residual) {
  TORCH_CHECK_VALUE(
      x.scalar_type() == at::kBFloat16 && x.dim() == 4 &&
          bn_act_pixel_stride(x) != -1,
      "x must be an NHWC bf16 tensor with adjacent channels and evenly "
      "spaced pixels, got ", x.scalar_type(), " ", x.sym_sizes(),
      " strides ", x.sym_strides());
  const c10::SymInt c = x.sym_size(3);
  for (const at::Tensor* t : {&scale, &shift}) {
    TORCH_CHECK_VALUE(t->scalar_type() == at::kFloat && t->dim() == 1 &&
                          t->sym_size(0) == c && t->is_contiguous(),
                      "scale and shift must be contiguous fp32 [C] with C = ",
                      c, ", got ", t->scalar_type(), " ", t->sym_sizes());
    TORCH_CHECK_VALUE(t->device() == x.device(),
                      "all operands must be on x's device");
  }
  if (residual.has_value()) {
    const at::Tensor& r = *residual;
    TORCH_CHECK_VALUE(r.scalar_type() == at::kBFloat16 &&
                          r.sym_sizes() == x.sym_sizes() &&
                          bn_act_pixel_stride(r) != -1,
                      "residual must be a bf16 tensor of x's sizes ",
                      x.sym_sizes(), " and layout, got ", r.scalar_type(),
                      " ", r.sym_sizes(), " strides ", r.sym_strides());
    TORCH_CHECK_VALUE(r.device() == x.device(),
                      "all operands must be on x's device");
  }
}

}  // namespace egonet
