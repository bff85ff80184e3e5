// The inference batch norm's epilogue of one element, for the CUDA kernel of
// bn_act.cu and the CPU kernel of egonet_ops.cpp alike (compiled by nvcc as
// __host__ __device__, by the host compiler as plain inline C++):
//
//   t = bf16(fmaf(x, scale[c], shift[c]))     the batch norm, rounded
//   t = bf16(t + r)                           with a residual r
//   t = max(t, 0)                             with relu
//
// x, r and t are bf16 bit patterns; scale = gamma / sqrt(var + eps) and
// shift = beta - mean * scale are the channel's fp32 affine
// (io/weights.bn_affine_tensors).  The roundings are the ones the unfused
// path makes: its cast of the fp32 batch norm back to bf16, then a bf16 add
// and a bf16 relu.  Both sides round with the same integer routine (torch's
// round to nearest even, NaN to 0x7FC0) and fmaf is one rounding on both,
// so the CUDA and CPU kernels agree bit for bit.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifndef EGONET_HD
#if defined(__CUDACC__)
#define EGONET_HD __host__ __device__ __forceinline__
#else
#define EGONET_HD inline
#endif
#endif

namespace egonet {
namespace bn {

EGONET_HD float bf16_float(uint16_t h) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(uint32_t(h) << 16);
#else
  const uint32_t u = uint32_t(h) << 16;
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

EGONET_HD uint16_t bf16_rn(float f) {
#if defined(__CUDA_ARCH__)
  const uint32_t u = __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, sizeof u);
#endif
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  return uint16_t((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

template <bool RES, bool RELU>
EGONET_HD uint16_t one(uint16_t x, float scale, float shift, uint16_t r) {
  uint16_t t = bf16_rn(fmaf(bf16_float(x), scale, shift));
  if (RES) t = bf16_rn(bf16_float(t) + bf16_float(r));
  if (RELU && bf16_float(t) < 0.0f) t = 0;
  return t;
}

}  // namespace bn
}  // namespace egonet
