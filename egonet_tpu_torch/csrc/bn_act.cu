// The inference batch norm's epilogue on the card, in one pass: an NHWC bf16
// tensor x [P pixels, C] -> y = relu?(bf16(x * scale + shift) + residual?)
// (bn_act.cuh's routine per element), reading x (and the residual) once and
// writing y [P, C] contiguous once.  x's and the residual's pixels lie
// x_stride and r_stride elements apart (C for a channels_last tensor, the
// whole width for a channel slice of one).  It is bound by bytes, so the
// design keeps device memory busy:
//
// * each thread owns one vector of VEC channels (8 bf16 = 16 bytes where
//   C and both strides are multiples of 8 and every pointer is 16-byte
//   aligned, else 2 or 1), holds its VEC scales and shifts in registers and
//   walks pixels, with no division per element;
// * a block is `rows` pixel rows of C / VEC threads each (about 256
//   threads), so a warp reads consecutive 16-byte pieces of consecutive
//   pixels; a channel count above 256 vectors spreads over blockIdx.y;
// * each thread has kUnroll independent pixels (x and residual loads) in
//   flight, over a grid of at most 8 blocks an SM striding the tensor.
//
// Plain C entry point, no torch headers (a build takes seconds);
// egonet_ops_cuda.cpp launches it for the operator egonet::bn_act on the
// current stream, never synchronising.

#include <cuda_runtime.h>

#include <cstdint>

#include "bn_act.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;

template <int VEC>
struct alignas(2 * VEC) Pack {
  uint16_t h[VEC];
};

template <int VEC>
__device__ __forceinline__ Pack<VEC> load(const uint16_t* p) {
  return *reinterpret_cast<const Pack<VEC>*>(p);
}

template <int VEC>
__device__ __forceinline__ void store(uint16_t* p, const Pack<VEC>& v) {
  *reinterpret_cast<Pack<VEC>*>(p) = v;
}

template <int VEC, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_act_kernel(const uint16_t* __restrict__ x,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift,
                  const uint16_t* __restrict__ res, uint16_t* __restrict__ y,
                  int64_t pixels, int c, int64_t x_stride, int64_t r_stride,
                  int vecs_per_block, int rows) {
  const int lane = threadIdx.x % vecs_per_block;
  const int row = threadIdx.x / vecs_per_block;
  const int ch = (blockIdx.y * vecs_per_block + lane) * VEC;
  if (ch >= c) return;
  float sc[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sc[i] = scale[ch + i];
    sh[i] = shift[ch + i];
  }
  const int64_t step = int64_t(gridDim.x) * rows;
  for (int64_t p0 = int64_t(blockIdx.x) * rows + row; p0 < pixels;
       p0 += step * kUnroll) {
    Pack<VEC> xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = p0 + u * step;
      if (p < pixels) {
        xv[u] = load<VEC>(x + p * x_stride + ch);
        if (RES) rv[u] = load<VEC>(res + p * r_stride + ch);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = p0 + u * step;
      if (p < pixels) {
        Pack<VEC> out;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          out.h[i] = egonet::bn::one<RES, RELU>(xv[u].h[i], sc[i], sh[i],
                                                RES ? rv[u].h[i] : 0);
        }
        store<VEC>(y + p * c + ch, out);
      }
    }
  }
}

int sm_count() {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 132;
  }
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

template <int VEC, bool RES, bool RELU>
int launch(const uint16_t* x, const float* scale, const float* shift,
           const uint16_t* res, uint16_t* y, int64_t pixels, int c,
           int64_t x_stride, int64_t r_stride, cudaStream_t stream) {
  const int vecs = c / VEC;
  const int per_block = vecs < kThreads ? vecs : kThreads;
  const int rows = kThreads / per_block;
  const int64_t wanted =
      (pixels + int64_t(rows) * kUnroll - 1) / (int64_t(rows) * kUnroll);
  const int64_t most = int64_t(sm_count()) * kBlocksPerSm;
  const dim3 grid(unsigned(wanted < most ? wanted : most),
                  unsigned((vecs + per_block - 1) / per_block));
  bn_act_kernel<VEC, RES, RELU><<<grid, per_block * rows, 0, stream>>>(
      x, scale, shift, res, y, pixels, c, x_stride, r_stride, per_block,
      rows);
  return int(cudaGetLastError());
}

template <int VEC>
int launch_vec(const uint16_t* x, const float* scale, const float* shift,
               const uint16_t* res, uint16_t* y, int64_t pixels, int c,
               int64_t x_stride, int64_t r_stride, bool relu,
               cudaStream_t stream) {
  using Launch = int (*)(const uint16_t*, const float*, const float*,
                         const uint16_t*, uint16_t*, int64_t, int, int64_t,
                         int64_t, cudaStream_t);
  const Launch go = res != nullptr
                        ? (relu ? &launch<VEC, true, true>
                                : &launch<VEC, true, false>)
                        : (relu ? &launch<VEC, false, true>
                                : &launch<VEC, false, false>);
  return go(x, scale, shift, res, y, pixels, c, x_stride, r_stride, stream);
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The widest vector the launch takes: 8 where C and both pixel strides are
// multiples of 8 and x, residual and y are 16-byte aligned, else 2 where
// they are even and 4-byte aligned, else 1.
int vec_width(const void* x, const void* residual, const void* y, int c,
              int64_t x_stride, int64_t r_stride) {
  const auto fits = [&](int vec) {
    const uintptr_t bytes = 2 * vec;
    return c % vec == 0 && x_stride % vec == 0 && r_stride % vec == 0 &&
           aligned(x, bytes) && aligned(residual, bytes) && aligned(y, bytes);
  };
  if (fits(8)) return 8;
  if (fits(2)) return 2;
  return 1;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for C < 1, P < 0 or a pixel stride below C.  P = 0
// launches nothing.  `residual` may be null (its stride is then unread).
int egonet_bn_act(const void* x, int64_t x_stride, const float* scale,
                  const float* shift, const void* residual, int64_t r_stride,
                  void* y, int64_t pixels, int c, int relu, void* stream) {
  if (residual == nullptr) r_stride = c;
  if (c < 1 || pixels < 0 || x_stride < c || r_stride < c) {
    return int(cudaErrorInvalidValue);
  }
  if (pixels == 0) return 0;
  const auto* xs = static_cast<const uint16_t*>(x);
  const auto* rs = static_cast<const uint16_t*>(residual);
  auto* ys = static_cast<uint16_t*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (vec_width(x, residual, y, c, x_stride, r_stride)) {
    case 8:
      return launch_vec<8>(xs, scale, shift, rs, ys, pixels, c, x_stride,
                           r_stride, relu != 0, s);
    case 2:
      return launch_vec<2>(xs, scale, shift, rs, ys, pixels, c, x_stride,
                           r_stride, relu != 0, s);
    default:
      return launch_vec<1>(xs, scale, shift, rs, ys, pixels, c, x_stride,
                           r_stride, relu != 0, s);
  }
}

}  // extern "C"
