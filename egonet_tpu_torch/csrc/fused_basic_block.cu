// Fused inference HRNet BasicBlock for Hopper (sm_90a), bf16 in / bf16 out.
//
//   y = relu(conv3x3(mid, W2') + b2 + x),  mid = relu(conv3x3(x, W1') + b1)
//
// stride 1, C_in == C_out, batch norm folded into W1'/b1 and W2'/b2.
// Replaces the Pallas TPU kernel egonet_tpu/ops/pallas_block.py
// (fused_basic_block / _block_kernel): the conv1 activation never leaves
// the chip — device memory sees one read of x and one write of y.
//
// Layouts: x, y NHWC bf16 contiguous (a channels_last NCHW tensor's
// storage); w1, w2 [C_out, 3, 3, C_in] bf16 (tap-major rows, the order of
// pack_block_weights); b1, b2 fp32 [C].  Accumulation is fp32; mid is
// rounded to bf16 (as the TPU kernel stores it).
//
// Bound on the H100: operations.  A launch does 4*B*H*W*9*C^2 operations
// (10.9 GFLOP at every W48 shape at B=32, 0.011 ms at 989 TFLOP/s) and must
// move 4*B*H*W*C + 36*C^2 bytes (2.3-7.5 us at 3.35 TB/s).  What stands
// between the kernel and that bound is feeding the tensor cores: every
// block reads both weight matrices (9C x C each, 2.65 MB at C=384) from L2,
// and every operand fragment reaches the tensor cores from shared memory.
// A block does (M1 + M2) / 2 operations per weight byte it streams (M1, M2:
// its real GEMM rows of conv1 and conv2), whatever C is: 26 at C=384 on a
// 4x4 tile, where the weight stream from L2 binds (1,792 blocks x 5.3 MB a
// launch at 448 crops; see PERF.md).  There a cluster of k blocks (the
// same tile of k images) shares each weight slab: one TMA load per slab
// share, multicast into every block of the cluster, so the weights leave
// L2 once per cluster (plan.cluster > 1; ops/fused_block.py, cluster_for,
// says where).
//
// Design:
//   * one thread block (8 warps) per NB images x TH x TW output tile; the
//     launch plan (tile, warp grid, K slab depth, slab buffers, shared-
//     memory layout) is computed by ops/fused_block.py (plan_for), passed
//     in as `Plan` and checked here against the layout the kernel uses;
//   * the input tile plus a 2-pixel halo, (TH+4) x (TW+4) positions per
//     image, is copied into shared memory with cp.async, zero outside the
//     image and past the batch;
//   * conv1 is an implicit GEMM whose M rows are the real mid positions,
//     NB x (TH+2) x (TW+2), and conv2 one whose rows are the real output
//     positions, NB x TH x TW.  ldmatrix takes one row address per lane,
//     so each lane points its row straight at its position's channels and
//     a tap (dy, dx) is a constant byte offset for every row: no position
//     is computed that is then thrown away, except the rows of the last M
//     tile past the real count, which read a valid position and are
//     dropped in the epilogue;
//   * the weights stream through shared memory in K slabs of KS columns
//     ([C][KS + 8] bf16, 2-3 slab buffers, copied by all threads with
//     cp.async), so every weight byte leaves L2 once per block and conv
//     (per pass, see below); the next conv's first slabs stream in during
//     the epilogue of the one before;
//   * with a cluster (TMA = true: k = plan.cluster blocks along the
//     images, KS = 64), a slab is [C][64] bf16 in TMA's 128-byte swizzle
//     (16-byte chunk c of row n at chunk c ^ (n % 8)), and block r of the
//     cluster loads rows [r C / k, (r + 1) C / k) of it into every block
//     of the cluster with one multicast TMA load, issued by a ninth warp
//     that does nothing else.  Each slab buffer has a "full" mbarrier (its
//     bytes have landed: the loading warp arrives with the bytes expected,
//     the k loads complete them) and an "empty" one (every computing warp
//     of every block of the cluster is done with it; the loading warp
//     waits on it before loading the block's share again).  The slabs of
//     both convs and all passes are one stream, loaded as soon as a buffer
//     is free, so the next conv's slabs land during the epilogue here too
//     and no computing warp waits for a load to be issued.  Blocks past the
//     batch (the grid's image count rounds up to a multiple of k) take
//     part in every load and barrier; their x is zero and their stores
//     are dropped;
//   * the warps form a WM x WN grid over the block's GEMM: warp (i, j)
//     owns N tiles j*NT .. j*NT+NT-1 (16 output channels each) and M tiles
//     i, i + WM, ... (MT of them per pass; more passes only where the
//     accumulators would not fit in registers), so each A fragment feeds NT
//     N tiles and each B fragment MT M tiles.  The K walk is compiled for
//     each count of real M tiles a warp can hold, so it has no branch per
//     tile; variants with few accumulators are held to 128 registers, two
//     blocks per SM;
//   * every fragment is one ldmatrix from a shared-space address; the row
//     addresses are computed once per pass and the K walk only adds byte
//     offsets (taps outer, 16-deep channel chunks inner, no division);
//     shared rows are C + 8 channels apart (an odd multiple of 16 bytes),
//     so the rows of an ldmatrix phase fall in distinct banks; the MMAs are
//     raw mma.sync.m16n8k16 bf16 -> fp32;
//   * the epilogues work on the accumulator registers (two adjacent
//     channels per bf16x2 store): conv1 writes relu(acc + b1) into the mid
//     tile, exact zero at positions outside the image (conv2's zero
//     padding); conv2 adds b2 and the staged x, applies relu and stores y.

#include <cuda.h>  // CUtensorMap (types only: no libcuda is linked)
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_sm90.cuh"

// The launch plan, computed by ops/fused_block.py (plan_for) and passed by
// value; the CUDA operator's copy (csrc/egonet_ops_cuda.cpp, TiledPlan,
// from _PLAN_FIELDS there) has the same fields in the same order.
struct Plan {
  int th, tw, nb;   // output tile rows, columns; images per block
  int cp;           // shared row pitch in channels (C + 8)
  int mt, nt, ks;   // M tiles per warp and pass, N tiles per warp, K slab
  int wm, wn;       // warps along M and along N
  int stages;       // weight slab buffers (2 or 3)
  int mid_off;      // byte offset of the mid tile in shared memory
  int slab_off;     // byte offset of the first weight slab
  int slab_bytes;   // bytes of one slab buffer
  int smem;         // dynamic shared memory of the block, bytes
  int cluster;      // blocks sharing each weight slab (1: no cluster)
};

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemLimit = 232448;
constexpr int kTmaKs = 64;      // a swizzled slab row: 128 bytes
constexpr int kBarBytes = 128;  // a cluster plan's mbarriers, after the slabs

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Passes over the weights of a conv of m_real GEMM rows (conv_gemm).
__host__ __device__ inline int passes_of(int m_real, const Plan& p) {
  return cdiv(cdiv(cdiv(m_real, 16), p.wm), p.mt);
}

// Checks the plan against the layout the kernel addresses: the x tile
// before mid_off, the mid tile before slab_off, `stages` slabs of
// [C][ks + 8] after it, all within the block's shared memory; with a
// cluster of 2 or 4, 2 to 8 swizzled [C][64] slabs at a 1024-byte
// boundary, each share of C / cluster rows one TMA box (at most 256 rows,
// a multiple of 8), and the full and empty barriers after the slabs.
__host__ inline bool plan_ok(const Plan& p, int C) {
  const size_t xs = size_t(p.nb) * (p.th + 4) * (p.tw + 4) * p.cp * 2;
  const size_t mid = size_t(p.nb) * (p.th + 2) * (p.tw + 2) * p.cp * 2;
  const bool slabs =
      p.cluster == 1
          ? size_t(p.slab_bytes) >= size_t(C) * (p.ks + 8) * 2 &&
                p.smem == p.slab_off + p.stages * p.slab_bytes
          : (p.cluster == 2 || p.cluster == 4) && p.ks == kTmaKs &&
                (C / p.cluster) % 8 == 0 && C / p.cluster <= 256 &&
                p.slab_off % 1024 == 0 && p.slab_bytes == C * kTmaKs * 2 &&
                p.smem == p.slab_off + p.stages * p.slab_bytes + kBarBytes;
  return C % 16 == 0 && p.cp == C + 8 && p.th >= 1 && p.tw >= 1 &&
         p.nb >= 1 && p.wm >= 1 && p.wn >= 1 && p.wm * p.wn <= kWarps &&
         p.wn * p.nt * 16 >= C && (9 * C) % p.ks == 0 &&
         p.stages >= 2 && p.stages <= (p.cluster == 1 ? 3 : kBarBytes / 16) &&
         p.mid_off % 128 == 0 &&
         p.slab_off % 128 == 0 && p.slab_bytes % 128 == 0 &&
         size_t(p.mid_off) >= xs && size_t(p.slab_off) >= p.mid_off + mid &&
         slabs && p.smem <= kSmemLimit;
}

// A cluster plan's slab stream, per thread: the slab being walked (its
// buffer and that buffer's phase).  Slab s of the stream is slab
// s % n_slabs of w1 for s < first (conv1's passes), else of w2.
struct Stream {
  unsigned full, empty;     // shared addresses of the barriers, 8 bytes apart
  const CUtensorMap* map1;  // TMA descriptors of w1 and w2
  const CUtensorMap* map2;
  int first, total;         // slabs of conv1, of both convs
  int buf;                  // the buffer of the slab being walked
  unsigned phase;           // that buffer's phase parity
};

// The loading warp (one lane): load this block's share of slab s of the
// stream into every block of the cluster, once every computing warp of the
// cluster is done with the slab that buffer held.
__device__ __forceinline__ void load_slab(const Stream& st, int s, int C,
                                          const Plan& p, unsigned slabs) {
  const int buf = s % p.stages;
  if (s >= p.stages)
    mbar_wait(st.empty + 8 * buf, unsigned(s / p.stages - 1) & 1u);
  mbar_arrive_expect_tx(st.full + 8 * buf, unsigned(p.slab_bytes));
  const int n_slabs = 9 * C / kTmaKs;
  const bool conv1 = s < st.first;
  const int rows = C / p.cluster;
  const int rank = int(cluster_ctarank());
  tma_load_multicast(slabs + buf * p.slab_bytes + rank * rows * kTmaKs * 2,
                     conv1 ? st.map1 : st.map2,
                     ((conv1 ? s : s - st.first) % n_slabs) * kTmaKs,
                     rank * rows, st.full + 8 * buf,
                     (unsigned short)((1u << p.cluster) - 1u));
}

// Start streaming the first stages - 1 K slabs of `w` into the slab
// buffers, one cp.async group each (every thread must call it).
template <int KS>
__device__ __forceinline__ void prefetch_slabs(
    const __nv_bfloat16* __restrict__ w, int C, const Plan p,
    unsigned slabs) {
  for (int j = 0; j < p.stages - 1; ++j) {
    if (j < 9 * C / KS) fetch_slab<KS>(slabs + j * p.slab_bytes, w, j, C);
    cp_async_commit();
  }
}

// The K walk of one pass (every thread must call it): every K slab of `w`
// through the slab buffers (the first stages - 1 already in flight), the
// warp's MTS M tiles (rows at `a_row`) against its NT N tiles (at `b_off`
// in a slab).  The K step s covers weight columns [16s, 16s + 16), tap
// (dy, dx) = divmod(16s / C, 3) at channels 16s % C: a byte offset that
// only grows, by 32 bytes per step and a tap jump when the channels wrap.
//
// With TMA (a cluster plan) the slabs come from the stream `st` instead:
// every computing warp waits for the slab's full barrier, walks it at the
// swizzled offsets `b_k` (per 16-deep K step), and tells every block of
// the cluster it is done with the buffer.
template <int MTS, int MT, int NT, int KS, bool TMA>
__device__ __forceinline__ void k_walk(float (&acc)[MT][NT][2][4],
                                       const unsigned (&a_row)[MT],
                                       const unsigned (&b_off)[NT],
                                       const unsigned (&b_k)[KS / 16],
                                       const __nv_bfloat16* __restrict__ w,
                                       int C, const Plan p, unsigned slabs,
                                       int pitch, Stream& st) {
  const int n_slabs = 9 * C / KS;
  const unsigned pos_bytes = unsigned(p.cp) * 2;
  const unsigned c_bytes = unsigned(C) * 2;
  const unsigned dy_step = unsigned(pitch - 2) * pos_bytes;  // dx 2 -> 0
  const unsigned slab_bytes = unsigned(p.slab_bytes);
  const unsigned slab_end = slabs + unsigned(p.stages) * slab_bytes;
  unsigned fetch = slabs + unsigned(p.stages - 1) * slab_bytes;
  unsigned cur = slabs;
  unsigned a_k = 0, k = 0;  // byte offsets: tap + channels, channels
  int dx = 0;
  for (int j = 0; j < n_slabs; ++j) {
    if constexpr (TMA) {
      mbar_wait(st.full + 8 * st.buf, st.phase);
      cur = slabs + unsigned(st.buf) * slab_bytes;
    } else {
      // slab j has landed, and every warp is done with slab j - 1, whose
      // buffer the next fetch reuses
      cp_async_wait_slab(p.stages);
      __syncthreads();
      if (j + p.stages - 1 < n_slabs)
        fetch_slab<KS>(fetch, w, j + p.stages - 1, C);
      cp_async_commit();
      fetch = fetch + slab_bytes == slab_end ? slabs : fetch + slab_bytes;
    }
    if constexpr (MTS > 0) {
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        unsigned b[NT][4];
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          if constexpr (TMA)
            ldsm_x4(cur + b_off[q] + b_k[kk], b[q]);
          else
            ldsm_x4(cur + b_off[q] + kk * 32, b[q]);
        }
#pragma unroll
        for (int i = 0; i < MTS; ++i) {
          unsigned a[4];
          ldsm_x4(a_row[i] + a_k, a);
#pragma unroll
          for (int q = 0; q < NT; ++q) {
            mma16816(acc[i][q][0], a, b[q][0], b[q][1]);
            mma16816(acc[i][q][1], a, b[q][2], b[q][3]);
          }
        }
        // next 16 channels; past the last, the next tap (no branch)
        k += 32;
        const bool wrap = k == c_bytes;
        const bool next_row = wrap && dx == 2;
        a_k += 32 + (wrap ? (next_row ? dy_step : pos_bytes) - c_bytes : 0u);
        dx = next_row ? 0 : dx + wrap;
        k = wrap ? 0u : k;
      }
    }
    if constexpr (TMA) {
      // this warp's reads of the buffer are done: tell block l of the
      // cluster (lane l), whose loading warp loads its share into it next
      __syncwarp();
      if (threadIdx.x % 32 < unsigned(p.cluster))
        mbar_arrive_cluster(
            map_shared_rank(st.empty + 8 * st.buf, threadIdx.x % 32));
      if (++st.buf == p.stages) {
        st.buf = 0;
        st.phase ^= 1u;
      }
    } else {
      cur = cur + slab_bytes == slab_end ? slabs : cur + slab_bytes;
    }
  }
}

// k_walk<mts, ...> for a run-time count 0 <= mts <= MT, so the walk itself
// has no branch per M tile
template <int MT, int NT, int KS, bool TMA, int I = MT>
__device__ __forceinline__ void k_walk_for(int mts,
                                           float (&acc)[MT][NT][2][4],
                                           const unsigned (&a_row)[MT],
                                           const unsigned (&b_off)[NT],
                                           const unsigned (&b_k)[KS / 16],
                                           const __nv_bfloat16* __restrict__ w,
                                           int C, const Plan p,
                                           unsigned slabs, int pitch,
                                           Stream& st) {
  if constexpr (I == 0) {
    k_walk<0, MT, NT, KS, TMA>(acc, a_row, b_off, b_k, w, C, p, slabs, pitch,
                               st);
  } else {
    if (mts == I)
      k_walk<I, MT, NT, KS, TMA>(acc, a_row, b_off, b_k, w, C, p, slabs,
                                 pitch, st);
    else
      k_walk_for<MT, NT, KS, TMA, I - 1>(mts, acc, a_row, b_off, b_k, w, C,
                                         p, slabs, pitch, st);
  }
}

// One conv3x3 of the block as an implicit GEMM, by the whole block (every
// thread must call it, with the first slabs of `w` in flight).  GEMM row r
// (0 <= r < m_real) reads the activation position row_pos(r) of the shared
// tile at `act` (CP channels per position, `pitch` positions per tile row),
// shifted by dy * pitch + dx positions for tap (dy, dx).  After each pass's
// K walk the first slabs of the next pass (or of `next_w`, the next conv's
// weights, if not null) start streaming, and then, for every real row,
// `row_info(r)` is called once and `store(info, channel, v0, v1)` for each
// pair of adjacent output channels the warp owns, with the bias added.
// With TMA the slabs come from the stream `st`, which runs on through the
// epilogue by itself (`next_w` is not read).
template <int MT, int NT, int KS, bool TMA, typename RowPos,
          typename RowInfo, typename Store>
__device__ __forceinline__ void conv_gemm(
    unsigned act, int pitch, int m_real, RowPos row_pos,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ next_w, int C, const Plan p,
    unsigned slabs, Stream& st, RowInfo row_info, Store store) {
  constexpr int KSP = KS + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm_i = warp % p.wm, wn_i = warp / p.wm;
  const bool active = wn_i < p.wn;  // warps past the grid only copy
  const int n_tiles = C / 16;
  const int m_tiles = (m_real + 15) / 16;
  const int slots = (m_tiles + p.wm - 1) / p.wm;  // M tiles per warp
  const int passes = passes_of(m_real, p);

  // B (weights, [n][k] in the slab): matrix l / 8 of an x4 load is rows
  // (output channels) 8 * (l / 16) + 0..7, k half (l / 8) % 2.  An N tile
  // past C (only where C / 16 is no multiple of NT) reads the last one and
  // is dropped in the epilogue.
  // Swizzled (TMA): rows of 128 bytes, and the K step kk's 16-byte chunk
  // 2 kk + k half of row n at chunk (2 kk + k half) ^ (n % 8), n % 8 being
  // lane % 8 here: b_k[kk] holds the K step's part of that offset.
  const unsigned b_lane =
      TMA ? (lane % 8 + 8 * (lane / 16)) * KS * 2 +
                ((((lane / 8) % 2) ^ (lane % 2)) * 16)
          : ((lane % 8 + 8 * (lane / 16)) * KSP + ((lane / 8) % 2) * 8) * 2;
  const unsigned row_bytes = TMA ? KS * 2 : KSP * 2;
  unsigned b_k[KS / 16];
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk)
    b_k[kk] = TMA ? ((unsigned(kk) ^ ((lane % 8) / 2)) * 32) : kk * 32;
  unsigned b_off[NT];
  bool n_ok[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int nt = wn_i * NT + q;
    n_ok[q] = active && nt < n_tiles;
    b_off[q] = b_lane + unsigned(min(nt, n_tiles - 1) * 16) * row_bytes;
  }

  for (int pass = 0; pass < passes; ++pass) {
    // A: lane l gives row l % 16 of the M tile at k half l / 16; the
    // warp's real M tiles of this pass are the first mts
    int m_t[MT];
    unsigned a_row[MT];
    int mts = 0;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int s = pass * MT + i;
      m_t[i] = s * p.wm + wm_i;
      mts += active && s < slots && m_t[i] < m_tiles;
      const int r = min(m_t[i] * 16 + lane % 16, m_real - 1);
      a_row[i] = act + unsigned(row_pos(r)) * p.cp * 2 + (lane / 16) * 16;
    }
    float acc[MT][NT][2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][q][h][e] = 0.0f;

    k_walk_for<MT, NT, KS, TMA>(mts, acc, a_row, b_off, b_k, w, C, p, slabs,
                                pitch, st);
    if constexpr (!TMA) {
      __syncthreads();  // every warp is done with the slab buffers
      const __nv_bfloat16* nw = pass + 1 < passes ? w : next_w;
      if (nw != nullptr) prefetch_slabs<KS>(nw, C, p, slabs);
    }

    // accumulator element e of half h: row lane / 4 + 8 * (e / 2), channel
    // 8 * h + 2 * (lane % 4) + e % 2 of the 16-channel N tile
    float2 bv[NT][2];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bv[q][h] = n_ok[q] ? *reinterpret_cast<const float2*>(
                                 bias + (wn_i * NT + q) * 16 + 8 * h +
                                 2 * (lane % 4))
                           : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mts) continue;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = m_t[i] * 16 + lane / 4 + 8 * e2;
        if (r >= m_real) continue;
        const auto info = row_info(r);
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          if (!n_ok[q]) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store(info, (wn_i * NT + q) * 16 + 8 * h + 2 * (lane % 4),
                  acc[i][q][h][2 * e2] + bv[q][h].x,
                  acc[i][q][h][2 * e2 + 1] + bv[q][h].y);
        }
      }
    }
  }
}

struct OutRow {
  long long y;  // element offset of the output position in y
  int res;      // element offset of the same position in the x tile
  bool ok;      // inside the image and the batch
};

// Two blocks per SM (128 registers a thread) where the accumulators are few
// (ops/fused_block.py, plan_for, sizes a cluster plan's slabs by the same
// test).  TMA: the cluster plan's variant, one loading warp after the 8
// computing ones (map1, map2: w1's and w2's descriptors, unread otherwise).
template <int MT, int NT, int KS, bool TMA>
__global__ void __launch_bounds__(TMA ? kThreads + 32 : kThreads,
                                  MT * NT <= 6 ? 2 : 1)
fused_basic_block_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w1,
                         const float* __restrict__ b1,
                         const __nv_bfloat16* __restrict__ w2,
                         const float* __restrict__ b2,
                         __nv_bfloat16* __restrict__ y, int N, int H, int W,
                         int C, Plan p, int tiles_x,
                         const __grid_constant__ CUtensorMap map1,
                         const __grid_constant__ CUtensorMap map2) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const unsigned xs = smem_addr(smem);
  const unsigned mid = xs + p.mid_off;
  const unsigned slabs = xs + p.slab_off;
  const __nv_bfloat16* xs_ptr = reinterpret_cast<const __nv_bfloat16*>(smem);
  __nv_bfloat16* mid_ptr = reinterpret_cast<__nv_bfloat16*>(smem + p.mid_off);
  const int TH = p.th, TW = p.tw, NB = p.nb, CP = p.cp;
  const int xh = TH + 4, xw = TW + 4, mh = TH + 2, mw = TW + 2;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * NB;
  constexpr int threads = TMA ? kThreads + 32 : kThreads;
  Stream st{};
  if constexpr (TMA) {
    const int n_slabs = 9 * C / KS;
    st.full = slabs + p.stages * p.slab_bytes;
    st.empty = st.full + 8 * p.stages;
    st.map1 = &map1;
    st.map2 = &map2;
    st.first = passes_of(NB * mh * mw, p) * n_slabs;
    st.total = st.first + passes_of(NB * TH * TW, p) * n_slabs;
    if (threadIdx.x == 0) {
      if (slabs % 1024 != 0) __trap();  // the swizzle needs the alignment
      for (int b = 0; b < p.stages; ++b) {
        mbar_init(st.full + 8 * b, 1);
        mbar_init(st.empty + 8 * b, kWarps * p.cluster);
      }
      fence_mbarrier_init();
      prefetch_tensormap(&map1);
      prefetch_tensormap(&map2);
    }
  }

  // 1. x[n0 : n0+NB, ty0-2 : ty0+TH+2, tx0-2 : tx0+TW+2] into shared memory,
  //    zero outside the image and past the batch (one cp.async group,
  //    committed before the first weight slabs, so the wait for slab 0
  //    covers it; with TMA waited for before conv1)
  const int cvec = C / 8;  // 16-byte vectors per position
  for (int i = threadIdx.x; i < NB * xh * xw * cvec; i += threads) {
    const int v = i % cvec, pos = i / cvec;
    const int sx = pos % xw, sy = (pos / xw) % xh, nb = pos / (xw * xh);
    const int n = n0 + nb, gy = ty0 - 2 + sy, gx = tx0 - 2 + sx;
    const bool valid = n < N && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const __nv_bfloat16* src =
        valid ? x + ((size_t(n) * H + gy) * W + gx) * C + v * 8 : x;
    cp_async16(xs + (pos * CP + v * 8) * 2, src, valid);
  }
  cp_async_commit();
  if constexpr (TMA) {
    // every block's barriers are set before any load or arrival reaches
    // them; then the loading warp streams every slab and waits for the
    // others at the end
    cluster_sync();
    cp_async_wait_all();
    __syncthreads();
    if (threadIdx.x >= kThreads) {
      if (threadIdx.x == kThreads) {
        for (int s = 0; s < st.total; ++s) load_slab(st, s, C, p, slabs);
      }
      __syncwarp();
      cluster_sync();
      return;
    }
  } else {
    prefetch_slabs<KS>(w1, C, p, slabs);
  }

  // 2. conv1 + b1 + relu over the NB x mh x mw mid positions, whose pixel
  //    is (ty0 - 1 + my, tx0 - 1 + mx); exact zero outside the image
  conv_gemm<MT, NT, KS, TMA>(
      xs, xw, NB * mh * mw,
      [&](int r) {
        const int mx = r % mw, my = (r / mw) % mh, nb = r / (mw * mh);
        return (nb * xh + my) * xw + mx;
      },
      w1, b1, w2, C, p, slabs, st,
      [&](int r) {
        const int mx = r % mw, my = (r / mw) % mh;
        const int gy = ty0 - 1 + my, gx = tx0 - 1 + mx;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        return make_int2(r * CP, in);  // mid rows are the GEMM rows
      },
      [&](int2 info, int co, float v0, float v1) {
        *reinterpret_cast<__nv_bfloat162*>(mid_ptr + info.x + co) =
            __floats2bfloat162_rn(info.y ? fmaxf(v0, 0.0f) : 0.0f,
                                  info.y ? fmaxf(v1, 0.0f) : 0.0f);
      });

  // 3. conv2 + b2 + residual (the staged x) + relu over the NB x TH x TW
  //    output positions (with TMA, once every warp's mid rows are written:
  //    without, the first slab's barrier in the K walk orders them)
  if constexpr (TMA) named_sync(1, kThreads);
  conv_gemm<MT, NT, KS, TMA>(
      mid, mw, NB * TH * TW,
      [&](int r) {
        const int ox = r % TW, oy = (r / TW) % TH, nb = r / (TW * TH);
        return (nb * mh + oy) * mw + ox;
      },
      w2, b2, nullptr, C, p, slabs, st,
      [&](int r) {
        const int ox = r % TW, oy = (r / TW) % TH, nb = r / (TW * TH);
        const int n = n0 + nb, gy = ty0 + oy, gx = tx0 + ox;
        OutRow o;
        o.ok = n < N && gy < H && gx < W;
        o.y = ((long long)(n) * H + gy) * W * C + (long long)(gx) * C;
        o.res = ((nb * xh + oy + 2) * xw + ox + 2) * CP;
        return o;
      },
      [&](const OutRow& o, int co, float v0, float v1) {
        if (!o.ok) return;
        const float2 res = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs_ptr + o.res + co));
        *reinterpret_cast<__nv_bfloat162*>(y + o.y + co) =
            __floats2bfloat162_rn(fmaxf(v0 + res.x, 0.0f),
                                  fmaxf(v1 + res.y, 0.0f));
      });
  cp_async_wait_all();
  // no block leaves while another may still arrive on its barriers
  if constexpr (TMA) cluster_sync();
}

// Launch (or, with `query`, ask how many clusters the card holds at once
// into *clusters): a grid of tiles x image groups, the groups rounded up to
// a multiple of the cluster, clustered along the images where the plan has
// a cluster.  map1, map2: w1's and w2's TMA descriptors (a cluster plan).
template <int MT, int NT, int KS, bool TMA>
int launch(bool query, int* clusters, const void* x, const void* w1,
           const void* b1, const void* w2, const void* b2, void* y, int N,
           int H, int W, int C, const Plan& p, const void* map1,
           const void* map2, cudaStream_t stream) {
  auto kernel = fused_basic_block_kernel<MT, NT, KS, TMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return int(err);
  const int tiles_x = cdiv(W, p.tw);
  const int tiles_y = cdiv(H, p.th);
  CUtensorMap m1, m2;
  memset(&m1, 0, sizeof m1);
  memset(&m2, 0, sizeof m2);
  if constexpr (!TMA) {
    dim3 grid(tiles_y * tiles_x, cdiv(N, p.nb));
    kernel<<<grid, kThreads, p.smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
        static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
        static_cast<__nv_bfloat16*>(y), N, H, W, C, p, tiles_x, m1, m2);
    return int(cudaGetLastError());
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = unsigned(p.cluster);
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(unsigned(tiles_y * tiles_x),
                       unsigned(cdiv(cdiv(N, p.nb), p.cluster) * p.cluster));
    cfg.blockDim = dim3(unsigned(kThreads + 32));
    cfg.dynamicSmemBytes = size_t(p.smem);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (query)
      return int(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
    if (map1 == nullptr || map2 == nullptr) return int(cudaErrorInvalidValue);
    memcpy(&m1, map1, sizeof m1);
    memcpy(&m2, map2, sizeof m2);
    err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
        static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
        static_cast<__nv_bfloat16*>(y), N, H, W, C, p, tiles_x, m1, m2);
    if (err != cudaSuccess) return int(err);
    return int(cudaGetLastError());
  }
}

int dispatch(bool query, int* clusters, const void* x, const void* w1,
             const void* b1, const void* w2, const void* b2, void* y, int N,
             int H, int W, int C, const Plan& p, const void* map1,
             const void* map2, cudaStream_t s) {
#define EGONET_VARIANT(MT_, NT_, KS_, TMA_)                                \
  if (p.mt == MT_ && p.nt == NT_ && p.ks == KS_ &&                         \
      (p.cluster > 1) == ((TMA_) != 0))                                    \
    return launch<MT_, NT_, KS_, (TMA_) != 0>(query, clusters, x, w1, b1,  \
                                              w2, b2, y, N, H, W, C, p,    \
                                              map1, map2, s);
  EGONET_VARIANTS
#undef EGONET_VARIANT
  return int(cudaErrorInvalidValue);
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (the library links no libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f)
               : nullptr;
  }();
  return fn;
}

}  // namespace

// The (MT, NT, KS, TMA) instantiations this library holds come from the
// build: ops/fused_block.py (library) lists those of its launch plans as
// EGONET_VARIANTS, a run of EGONET_VARIANT(MT, NT, KS, TMA), in a prelude
// that ops/_build.py includes before this file.
#ifndef EGONET_VARIANTS
#error "EGONET_VARIANTS is undefined: build through egonet_tpu_torch/ops/_build.py"
#endif

extern "C" {

// Launch on `stream` with the plan `p`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a plan the kernel cannot run or
// this library does not hold.  All pointers must be 16-byte aligned (the
// caller checks).  A cluster plan (p.cluster > 1) also takes w1's and w2's
// TMA descriptors, each the 128 bytes egonet_fused_basic_block_weight_map
// wrote (copied at the launch); others take null.
int egonet_fused_basic_block(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* y, int N,
                             int H, int W, int C, Plan p, const void* map1,
                             const void* map2, void* stream) {
  if (N < 1 || H < 1 || W < 1 || !plan_ok(p, C))
    return int(cudaErrorInvalidValue);
  return dispatch(false, nullptr, x, w1, b1, w2, b2, y, N, H, W, C, p, map1,
                  map2, static_cast<cudaStream_t>(stream));
}

// The TMA descriptor of a [C, 3, 3, C] bf16 weight `w` ([C][9C] rows) for
// the cluster plan `p`: boxes of 64 columns x C / p.cluster rows in the
// 128-byte swizzle, written to `map` (128 bytes, 64-byte aligned).
// Returns the encoder's CUresult (0 on success; CUDA_ERROR_NOT_FOUND if no
// encoder is found), or CUDA_ERROR_INVALID_VALUE for a plan without
// a cluster.
int egonet_fused_basic_block_weight_map(const void* w, int C, Plan p,
                                        void* map) {
  if (p.cluster < 2 || !plan_ok(p, C)) return int(CUDA_ERROR_INVALID_VALUE);
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return int(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[2] = {cuuint64_t(9) * C, cuuint64_t(C)};
  const cuuint64_t strides[1] = {cuuint64_t(9) * C * 2};
  const cuuint32_t box[2] = {cuuint32_t(kTmaKs), cuuint32_t(C / p.cluster)};
  const cuuint32_t steps[2] = {1, 1};
  return int(encode(static_cast<CUtensorMap*>(map),
                    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                    const_cast<void*>(w), dims, strides, box, steps,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// How many clusters of the cluster plan `p` the card holds at once
// (cudaOccupancyMaxActiveClusters) into *clusters; returns the error.
int egonet_fused_basic_block_clusters(int C, Plan p, int* clusters) {
  *clusters = 0;
  if (p.cluster < 2 || !plan_ok(p, C)) return int(cudaErrorInvalidValue);
  return dispatch(true, clusters, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, p.cluster * p.nb, p.th, p.tw, C, p,
                  nullptr, nullptr, nullptr);
}

}  // extern "C"
