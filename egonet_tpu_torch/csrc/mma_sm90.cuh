// Shared-memory tensor-core helpers for the port's Hopper (sm_90a) kernels:
// cp.async copies into shared memory, ldmatrix fragment loads from
// shared-space addresses, the bf16 mma.sync.m16n8k16 with fp32
// accumulators, thread-block cluster barriers and distributed shared
// memory stores (the stencil kernel), and mbarriers with TMA tensor loads
// multicast across a cluster (the tiled kernel's shared weight slabs).
// Included by
// fused_basic_block.cu and fused_basic_block_stencil.cu; each builds into
// its own library, so the helpers have internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ inline size_t align128(size_t b) {
  return (b + 127) & ~size_t(127);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most stages - 2 copy groups are pending (stages 2 or 3)
__device__ __forceinline__ void cp_async_wait_slab(int stages) {
  if (stages >= 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, col-major), fp32
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start copying K slab j of a tap-major [C][9C] bf16 weight matrix (columns
// [KS*j, KS*j + KS) of every output channel) into a shared [C][KS + 8]
// buffer at shared address `dst`, with every thread of the block.  A row
// pitch of KS + 8 elements is an odd multiple of 16 bytes, so the 8 rows of
// an ldmatrix phase hit distinct banks.
template <int KS>
__device__ __forceinline__ void fetch_slab(unsigned dst,
                                           const __nv_bfloat16* __restrict__ w,
                                           int j, int C) {
  constexpr int vec = KS / 8;  // 16-byte vectors per row
  constexpr int ksp = KS + 8;
  const size_t k9 = size_t(9) * C;
  for (int i = threadIdx.x; i < C * vec; i += blockDim.x) {
    const int r = i / vec, v = i % vec;
    cp_async16(dst + (r * ksp + v * 8) * 2, w + r * k9 + j * KS + v * 8,
               true);
  }
}

// 16 bytes from global to shared memory, no zero fill: its SASS form (an
// LDGSTS without cp_async16's trailing zero-fill predicate) tells a weight
// copy from an activation copy
__device__ __forceinline__ void cp_async16_all(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// wait until at most N copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two 8x8 b16 matrices; lanes 0-15 give the row addresses (lane l of
// matrix l / 8)
__device__ __forceinline__ void ldsm_x2(unsigned addr, unsigned (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// ---- thread block clusters and distributed shared memory ----

// this block's rank in its cluster
__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the shared::cluster address of shared address `addr` in block `rank`
// of the cluster
__device__ __forceinline__ unsigned map_shared_rank(unsigned addr,
                                                    unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into (possibly another block's) shared memory of the cluster
__device__ __forceinline__ void st_cluster_v4(unsigned addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

// every thread of every block of the cluster arrives; the writes before
// it (shared, distributed shared and global) are visible after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// ---- mbarriers and TMA loads multicast across a cluster ----

// an mbarrier at shared address `bar` expecting `count` arrivals a phase
// (one thread; fence_mbarrier_init before any other block may use it)
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the barriers initialised before it are visible to the whole cluster
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// wait until the phase of parity `parity` of this block's barrier `bar`
// has completed (the loads it counts have landed)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// arrive on this block's barrier `bar` and add `bytes` to the bytes its
// phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// arrive on a barrier of the cluster (a shared::cluster address, from
// map_shared_rank), after this thread's earlier reads
__device__ __forceinline__ void mbar_arrive_cluster(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// a barrier of the first `n` threads of the block (a multiple of 32), `id`
// other than 0 (__syncthreads')
__device__ __forceinline__ void named_sync(unsigned id, unsigned n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// fetch a TMA descriptor (a __grid_constant__ kernel parameter) ahead
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One TMA load of the box at (column c0, row c1) of the 2-D tensor map
// `map` into shared address `dst` of every block of the cluster in `mask`;
// each block's barrier at shared address `bar` counts the bytes landed.
__device__ __forceinline__ void tma_load_multicast(unsigned dst,
                                                   const void* map, int c0,
                                                   int c1, unsigned bar,
                                                   unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "h"(mask)
      : "memory");
}

}  // namespace
