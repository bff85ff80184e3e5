// The rigid solve of the facade's `rigid` stage on the card, one launch for
// the whole batch: kpts [N, P, 3] fp32 (P = 32 or 33) -> out [N, 6] fp32 =
// (rx, ry, rz, tx, ty, tz).  One thread per crop runs rigid_solve.cuh's
// rigid_solve_one in registers (the template fit, the Horn covariance, 36
// Jacobi rotations of a 4x4, the quaternion's euler angles); 128 threads a
// block, so a 512-crop bucket is 4 blocks.  A crop reads its 96-99 floats
// and writes 6: the launch is a few microseconds, where the same solve as
// torch ops was ~1,450 launches.
//
// Plain C entry point, no torch headers (a build takes seconds);
// egonet_ops_cuda.cpp launches it for the operator egonet::rigid_solve on
// the current stream, never synchronising.

#include <cuda_runtime.h>

#include <cstdint>

#include "rigid_solve.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    rigid_solve_kernel(const float* __restrict__ kpts,
                       float* __restrict__ out, int n, int p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  egonet::rigid_solve_one(kpts + int64_t(i) * p * 3, p,
                          out + int64_t(i) * 6);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for P other than 32 or 33.  N = 0 launches nothing.
int egonet_rigid_solve(const float* kpts, float* out, int n, int p,
                       void* stream) {
  if (n < 0 || (p != 32 && p != 33)) return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  rigid_solve_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(kpts, out, n, p);
  return int(cudaGetLastError());
}

}  // extern "C"
