// Row-streaming (stencil) fused inference HRNet BasicBlock for Hopper
// (sm_90a), bf16 in / bf16 out.
//
//   y = relu(conv3x3(mid, W2') + b2 + x),  mid = relu(conv3x3(x, W1') + b1)
//
// stride 1, C_in == C_out, batch norm folded into W1'/b1 and W2'/b2: the
// same function as fused_basic_block.cu, computed by sweeping rows.
// Replaces the Pallas TPU kernel egonet_tpu/ops/pallas_block_stencil.py
// (fused_basic_block_stencil / _stencil_kernel).
//
// Layouts: x, y NHWC bf16 contiguous; w1, w2 [C_out, 3, 3, C_in] bf16
// (tap-major rows, unpermuted: the ring slot of a row is computed from the
// row index, so the TPU kernel's three rotation-permuted copies of W2 are
// not needed); b1, b2 fp32 [C].  Accumulation is fp32; mid is rounded to
// bf16, as the tiled kernel and the TPU kernel store it.
//
// Bound on the H100: operations.  A launch does 4*B*H*W*9*C^2 operations
// (10.9 GFLOP at every W48 shape at B=32, 0.01099 ms at 989 TFLOP/s) and
// must move 4*B*H*W*C + 36*C^2 bytes (2.3-7.5 us at 3.35 TB/s).  What the
// design does about it: both convs run on bf16 tensor cores (mma.sync
// m16n8k16 fed by ldmatrix, fp32 accumulators), and conv1 is recomputed
// only over a 2-column halo (x(TW+2)/TW), never over a row halo, since one
// block sweeps every row of its column tile; each x row is read from
// device memory once per column tile, and mid never leaves shared memory.
// What it pays: one block per (column tile, image group), far fewer blocks
// than the tiled kernel, each a serial chain over H+2 row steps, and every
// block streams both weight matrices from L2 once per row step.  On the
// H100 that chain's latency, not the operations, sets its time, so it
// gains from more resident blocks (narrow tiles, little shared memory) and
// not from more work per block.  wgmma, TMA and clusters that share mid
// rows are later work (PERF.md has its times).
//
// Design:
//   * one thread block owns TW output columns of NB images and loops
//     s = 0 .. H+1;
//   * x rows live in a 4-slot shared-memory ring, row r in slot r mod 4,
//     each slot [NB][XP][CP] holding columns tx0-2 .. tx0+TW+1 (zero
//     outside the image); row s+1 is fetched with cp.async while step s
//     computes;
//   * step s computes conv1 for mid row m = s-1 over TW+2 columns into the
//     3-slot mid ring (slot m mod 3), zero for rows and columns outside the
//     image; then, for s >= 2, conv2 for output row s-2 from the mid rows
//     s-3, s-2, s-1, plus b2, the residual x row (still in the ring) and
//     relu;
//   * each conv row is an implicit GEMM [NB * 16*MT] x [9C] x [C] whose 16
//     row M tiles lie inside one image's row (a tap (dy, dx) is the ring
//     slot of row dy and an offset of dx positions); rows past the tile
//     are computed and thrown away;
//   * the weights do not fit in shared memory for C >= 96, so the block
//     streams them through it in K slabs of 48 ([C_out][48] bf16, 2-3
//     slabs in flight with cp.async, copied by all threads at once); warp
//     w owns the N tiles w, w + warps, ... and every M tile, so each B
//     fragment read from shared memory feeds every M tile;
//   * every operand fragment is one ldmatrix from a shared-memory address
//     computed outside the K loop; shared rows are C + 8 channels apart
//     (an odd multiple of 16 bytes), so the 8 rows of an ldmatrix phase
//     hit distinct banks; the epilogue works on the accumulator registers
//     directly (two adjacent channels per store);
//   * a ragged last column tile is masked, so any W works.  C <= 384.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMT = 2;       // M tiles per GEMM pass (the accumulators held)
constexpr int kMaxNPW = 3;   // N tiles per warp: C <= 16 * 8 * 3 = 384
constexpr int kKS = 48;      // K slab depth (divides 9C for every C % 16 == 0)
constexpr int kKSP = kKS + 8;  // slab row pitch: 112 bytes, conflict-free
constexpr int kSmemLimit = 232448;

struct Geometry {
  int mt1;  // 16-row M tiles of conv1 per image (TW + 2 mid columns)
  int mt2;  // 16-row M tiles of conv2 per image (TW output columns)
  int xp;   // x ring row pitch per image, in positions
  int mp;   // mid ring row pitch per image, in positions
};

__host__ __device__ inline Geometry geometry(int TW) {
  Geometry g;
  g.mt1 = (TW + 2 + 15) / 16;
  g.mt2 = (TW + 15) / 16;
  // a fragment of tap dx reads positions col0 .. col0 + 15 + dx
  g.xp = g.mt1 * 16 + 2;
  g.mp = g.mt1 * 16 > g.mt2 * 16 + 2 ? g.mt1 * 16 : g.mt2 * 16 + 2;
  return g;
}

// shared row pitch in channels: an odd multiple of 8, so that the 16-byte
// rows of one ldmatrix phase fall in distinct banks
__host__ __device__ inline int pitch_for(int C) { return C + 8; }

// N tiles per warp, and warps per block: the C/16 N tiles spread evenly
// over at most kMaxWarps warps
__host__ __device__ inline int npw_for(int C) {
  return (C / 16 + kMaxWarps - 1) / kMaxWarps;
}

__host__ __device__ inline int warps_for(int C) {
  const int npw = npw_for(C);
  return (C / 16 + npw - 1) / npw;
}

__host__ __device__ inline size_t x_slot_bytes(const Geometry& g, int NB,
                                               int C) {
  return align128(size_t(NB) * g.xp * pitch_for(C) * 2);
}

__host__ __device__ inline size_t mid_slot_bytes(const Geometry& g, int NB,
                                                 int C) {
  return align128(size_t(NB) * g.mp * pitch_for(C) * 2);
}

__host__ __device__ inline size_t slab_bytes(int C) {
  return align128(size_t(C) * kKSP * 2);
}

__host__ __device__ inline size_t smem_bytes(int TW, int NB, int C,
                                             int stages) {
  const Geometry g = geometry(TW);
  return 4 * x_slot_bytes(g, NB, C) + 3 * mid_slot_bytes(g, NB, C) +
         stages * slab_bytes(C);
}

// three weight slabs in flight where they fit, else two
__host__ __device__ inline int stages_for(int TW, int NB, int C) {
  return smem_bytes(TW, NB, C, 3) <= size_t(kSmemLimit) ? 3 : 2;
}

__device__ __forceinline__ int ring4(int r) { return (r + 8) & 3; }  // r >= -2
__device__ __forceinline__ int ring3(int m) { return (m + 3) % 3; }  // m >= -1

// Start copying x row r (columns tx0-2 .. tx0-2+XP-1 of images n0 ..
// n0+NB-1) into the ring slot at shared address `slot`; positions outside
// the image, past the tile or past the batch are zero-filled.
__device__ __forceinline__ void fetch_x_row(
    unsigned slot, const __nv_bfloat16* __restrict__ x, int r, int n0,
    int tx0, int N, int H, int W, int C, int CP, int TW, int NB, int xp) {
  const int cvec = C / 8;  // 16-byte vectors per position
  const int total = NB * xp * cvec;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int v = i % cvec, pos = i / cvec;
    const int nb = pos / xp, xc = pos % xp;
    const int n = n0 + nb, gx = tx0 - 2 + xc;
    const bool valid = n < N && r >= 0 && r < H && xc < TW + 4 && gx >= 0 &&
                       gx < W;
    const __nv_bfloat16* src =
        valid ? x + ((size_t(n) * H + r) * W + gx) * C + v * 8 : x;
    cp_async16(slot + (pos * CP + v * 8) * 2, src, valid);
  }
}

// One conv row as an implicit GEMM over `m_tiles` 16-row M tiles, by the
// whole block (every thread must call it).  M tile t is image t / mt,
// positions (t % mt) * 16 + 0..15 of a row whose shared slots for dy =
// 0, 1, 2 start at `row0`, `row1`, `row2` (`pitch` positions per image,
// CP channels per position); tap (dy, dx) reads slot dy shifted by dx
// positions.  The K axis (9C deep, tap-major) streams through shared
// memory in slabs of kKS; warp w owns the N tiles w, w + warps, ... (NPW
// of them) and, per pass, up to kMT M tiles.  `epilogue(t, position,
// channel, v0, v1)` receives two adjacent output channels of one
// position (before bias).
template <int NPW, typename Epilogue>
__device__ __forceinline__ void row_gemm(unsigned row0, unsigned row1,
                                         unsigned row2, int pitch, int mt,
                                         int m_tiles, int CP,
                                         const __nv_bfloat16* __restrict__ w,
                                         int C, unsigned slabs, int stages,
                                         Epilogue epilogue) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int n_tiles = C / 16;
  const int n_slabs = 9 * C / kKS;
  const unsigned slab_stride = unsigned(slab_bytes(C));
  // ldmatrix lane offsets: A rows lane % 16, k half lane / 16; B rows
  // (output channels) lane % 8 + 8 * (lane / 16), k half (lane / 8) % 2
  const unsigned a_lane = ((lane % 16) * CP + (lane / 16) * 8) * 2;
  const unsigned b_lane =
      ((lane % 8 + 8 * (lane / 16)) * kKSP + ((lane / 8) % 2) * 8) * 2;
  for (int m0 = 0; m0 < m_tiles; m0 += kMT) {
    const int mts = min(kMT, m_tiles - m0);  // block-uniform
    unsigned a_pos[kMT];                     // byte offset of each M tile
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int t = min(m0 + i, m_tiles - 1);
      a_pos[i] = (((t / mt) * pitch + (t % mt) * 16) * CP) * 2 + a_lane;
    }
    float acc[NPW][kMT][2][4];
#pragma unroll
    for (int q = 0; q < NPW; ++q)
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][i][h][e] = 0.0f;

    __syncthreads();  // every warp is done with the slab buffers
    for (int j = 0; j < stages - 1; ++j) {
      if (j < n_slabs)
        fetch_slab<kKS>(slabs + (j % stages) * slab_stride, w, j, C);
      cp_async_commit();
    }
    int tap = 0, k0 = 0;  // K step s = tap * C/16 + k0/16
    for (int j = 0; j < n_slabs; ++j) {
      // slab j has landed, and every warp is done with slab j - 1, whose
      // buffer the next fetch reuses
      cp_async_wait_slab(stages);
      __syncthreads();
      const int jn = j + stages - 1;
      if (jn < n_slabs)
        fetch_slab<kKS>(slabs + (jn % stages) * slab_stride, w, jn, C);
      cp_async_commit();
      const unsigned sl = slabs + (j % stages) * slab_stride + b_lane;
#pragma unroll
      for (int kk = 0; kk < kKS / 16; ++kk) {
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        const unsigned row = dy == 0 ? row0 : (dy == 1 ? row1 : row2);
        const unsigned a_tap = row + (dx * CP + k0) * 2;
        unsigned b[NPW][4];
#pragma unroll
        for (int q = 0; q < NPW; ++q) {
          const int nt = warp + q * warps;
          if (nt < n_tiles)
            ldsm_x4(sl + (nt * 16 * kKSP + kk * 16) * 2, b[q]);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          if (i < mts) {
            unsigned a[4];
            ldsm_x4(a_tap + a_pos[i], a);
#pragma unroll
            for (int q = 0; q < NPW; ++q) {
              if (warp + q * warps < n_tiles) {
                mma16816(acc[q][i][0], a, b[q][0], b[q][1]);
                mma16816(acc[q][i][1], a, b[q][2], b[q][3]);
              }
            }
          }
        }
        k0 += 16;
        if (k0 == C) {
          k0 = 0;
          ++tap;
        }
      }
    }

    // accumulator element e of half h: row lane / 4 + 8 * (e / 2), column
    // 8 * h + 2 * (lane % 4) + e % 2
#pragma unroll
    for (int q = 0; q < NPW; ++q) {
      const int nt = warp + q * warps;
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (i < mts && nt < n_tiles) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              epilogue(m0 + i, lane / 4 + 8 * r,
                       nt * 16 + 8 * h + 2 * (lane % 4),
                       acc[q][i][h][2 * r], acc[q][i][h][2 * r + 1]);
        }
      }
    }
  }
}

template <int NPW>
__global__ void __launch_bounds__(kMaxWarps * 32)
fused_basic_block_stencil_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ w1,
                                 const float* __restrict__ b1,
                                 const __nv_bfloat16* __restrict__ w2,
                                 const float* __restrict__ b2,
                                 __nv_bfloat16* __restrict__ y, int N, int H,
                                 int W, int C, int TW, int NB, int stages,
                                 int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry g = geometry(TW);
  const int CP = pitch_for(C);
  const unsigned xsb = unsigned(x_slot_bytes(g, NB, C));
  const unsigned msb = unsigned(mid_slot_bytes(g, NB, C));
  const unsigned base = smem_addr(smem);
  const unsigned ms0 = base + 4 * xsb;           // mid ring, shared address
  const unsigned slabs = ms0 + 3 * msb;
  __nv_bfloat16* mid_ptr = reinterpret_cast<__nv_bfloat16*>(smem + 4 * xsb);
  const __nv_bfloat16* x_ptr = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = (blockIdx.x / tiles_x) * NB;
  const int xp = g.xp, mp = g.mp, mt1 = g.mt1, mt2 = g.mt2;

  // x rows -2, -1 (zero) and 0 before the first step
  for (int r = -2; r <= 0; ++r)
    fetch_x_row(base + ring4(r) * xsb, x, r, n0, tx0, N, H, W, C, CP, TW, NB,
                xp);
  cp_async_commit();

  for (int s = 0; s < H + 2; ++s) {
    // x row s has landed; every thread is done with step s-1
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < H + 2)
      fetch_x_row(base + ring4(s + 1) * xsb, x, s + 1, n0, tx0, N, H, W, C,
                  CP, TW, NB, xp);
    cp_async_commit();

    // conv1 + b1 + relu: mid row m = s-1, mid column mc is the absolute
    // column tx0-1+mc; zero outside the image (conv2's zero padding)
    const int m = s - 1;
    __nv_bfloat16* mid = mid_ptr + ring3(m) * (msb / 2);
    if (m >= 0 && m < H) {
      row_gemm<NPW>(
          base + ring4(m - 1) * xsb, base + ring4(m) * xsb,
          base + ring4(m + 1) * xsb, xp, mt1, NB * mt1, CP, w1, C, slabs,
          stages, [&](int t, int p, int co, float v0, float v1) {
            const int mc = (t % mt1) * 16 + p;
            if (mc < TW + 2) {
              const int gx = tx0 - 1 + mc;
              const bool in = gx >= 0 && gx < W;
              const __nv_bfloat162 v = __floats2bfloat162_rn(
                  in ? fmaxf(v0 + b1[co], 0.0f) : 0.0f,
                  in ? fmaxf(v1 + b1[co + 1], 0.0f) : 0.0f);
              *reinterpret_cast<__nv_bfloat162*>(
                  mid + size_t((t / mt1) * mp + mc) * CP + co) = v;
            }
          });
    } else {
      const int cvec = NB * mp * CP / 8;
      for (int i = threadIdx.x; i < cvec; i += blockDim.x)
        reinterpret_cast<uint4*>(mid)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();

    // conv2 + b2 + residual + relu: output row yr = s-2 from mid rows
    // yr-1, yr, yr+1
    if (s >= 2) {
      const int yr = s - 2;
      const __nv_bfloat16* xres = x_ptr + ring4(yr) * (xsb / 2);
      row_gemm<NPW>(
          ms0 + ring3(yr - 1) * msb, ms0 + ring3(yr) * msb,
          ms0 + ring3(yr + 1) * msb, mp, mt2, NB * mt2, CP, w2, C, slabs,
          stages, [&](int t, int p, int co, float v0, float v1) {
            const int nb = t / mt2, ox = (t % mt2) * 16 + p;
            const int gx = tx0 + ox, n = n0 + nb;
            if (ox < TW && gx < W && n < N) {
              const float2 res = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      xres + size_t(nb * xp + ox + 2) * CP + co));
              *reinterpret_cast<__nv_bfloat162*>(
                  y + ((size_t(n) * H + yr) * W + gx) * C + co) =
                  __floats2bfloat162_rn(fmaxf(v0 + b2[co] + res.x, 0.0f),
                                        fmaxf(v1 + b2[co + 1] + res.y, 0.0f));
            }
          });
    }
  }
  cp_async_wait_all();
}

template <int NPW>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* y, int N, int H, int W, int C, int TW,
           int NB, cudaStream_t stream) {
  const int stages = stages_for(TW, NB, C);
  const size_t smem = smem_bytes(TW, NB, C, stages);
  if (smem > size_t(kSmemLimit)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_basic_block_stencil_kernel<NPW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles_x = (W + TW - 1) / TW;
  const int groups = (N + NB - 1) / NB;
  fused_basic_block_stencil_kernel<NPW>
      <<<tiles_x * groups, warps_for(C) * 32, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(w1),
          static_cast<const float*>(b1),
          static_cast<const __nv_bfloat16*>(w2),
          static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(y), N,
          H, W, C, TW, NB, stages, tiles_x);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a TW-column tile of NB images
// at width C (more than 232448 bytes: the tile does not fit).
long long egonet_fused_basic_block_stencil_smem(int TW, int NB, int C) {
  return (long long)smem_bytes(TW, NB, C, stages_for(TW, NB, C));
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  C must
// be a multiple of 16 and at most 384, all pointers 16-byte aligned (the
// caller checks).
int egonet_fused_basic_block_stencil(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* y, int N, int H,
                                     int W, int C, int TW, int NB,
                                     void* stream) {
  if (C % 16 != 0 || C > 16 * kMaxWarps * kMaxNPW || TW < 1 || NB < 1 ||
      N < 1 || H < 1 || W < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (npw_for(C)) {
    case 1: return launch<1>(x, w1, b1, w2, b2, y, N, H, W, C, TW, NB, s);
    case 2: return launch<2>(x, w1, b1, w2, b2, y, N, H, W, C, TW, NB, s);
    default: return launch<3>(x, w1, b1, w2, b2, y, N, H, W, C, TW, NB, s);
  }
}

}  // extern "C"
