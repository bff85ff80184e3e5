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
// must move 4*B*H*W*C + 36*C^2 bytes (2.3-7.5 us at 3.35 TB/s).  Each
// cluster sweeps every row of its column tile, so conv1 is recomputed only
// over a 2-column halo, each x row is read once per block, and mid never
// leaves shared memory.  The sweep is a serial chain of row steps, so what
// sets the time is the length of one step, and the design keeps the
// weights' round trips out of it: each block holds its share of W1 and W2
// in shared memory for the whole sweep (copied once, before the first
// step), so a step is one K walk from shared memory, the exchange of the
// new mid rows and one barrier.  Where one block cannot hold both
// matrices, the output channels are split over a thread-block cluster;
// where no cluster holds them (C=384) each block streams only its share
// through shared memory in K slabs, every step.  What binds now (PERF.md):
// reading the weight share out of shared memory with ldmatrix every step
// (hundreds of bytes per mma.sync, against the 128 bytes a cycle an SM
// reads), the waves of one ~223 KB block per SM at C=192, and the L2
// weight stream at C=384; wgmma from shared memory and TMA multicast of
// the slabs are the next design.
//
// Design:
//   * the launch plan (column tile TW, rows per step R, images per
//     cluster NB, cluster size K, resident or streamed weights, warp grid,
//     ring sizes, shared-memory offsets) is reckoned by
//     ops/fused_block_stencil.py (plan_for), passed in as `StencilPlan`
//     and checked here (plan_ok);
//   * a cluster of K blocks owns TW output columns of NB images and sweeps
//     steps s = 1 .. ceil((H+1)/R) + 1; block k computes output channels
//     [k*C/K, (k+1)*C/K) of both convs;
//   * x rows live in a ring of (ahead + 1) R + 2 slots, row r in slot r
//     mod that, each slot [NB][TW+4][C+8] holding columns tx0-2 ..
//     tx0+TW+1 (zero outside the image and past the batch); every block
//     fetches its own rows with all C channels, with cp.async, `ahead`
//     (2, or 1 where the ring has no room) steps before the step that
//     reads them;
//   * step s computes conv1 for mid rows R(s-1) .. R(s-1)+R-1 and conv2
//     for output rows R(s-2)-1 .. R(s-2)+R-2 (from mid rows computed in
//     earlier steps): the two are independent within a step, so some of
//     the block's warps run conv1's K walk and the others conv2's, side
//     by side, and each B fragment a warp loads feeds all of its M tiles
//     of the step.  Block k writes its channels of the new mid rows into
//     its own mid ring (2R + 2 slots) and then, 16 bytes a store by all
//     threads, into every other block's through distributed shared memory
//     (mapa + st.shared::cluster); one cluster barrier ends the step.
//     2R + 2 slots make that one barrier enough: the rows a step writes
//     are none of those its conv2 reads, and the slots a block writes in
//     step s+1 were last read in step s, before the barrier.  The mid ring
//     starts zero (row -1), and conv1 writes zeros for rows H and past and
//     columns outside the image (conv2's zero padding); the residual is
//     read from x (in L2, where the ring's copy put it) before the walk;
//   * GEMM rows are real positions only: conv1's R x NB x (TW+2) mid
//     positions (R x NB x W where one tile spans the image, whose halo is
//     zero padding) and conv2's R x NB x TW output positions pack into
//     16-row M tiles, each lane's ldmatrix row address pointing at its own
//     position in the ring slot of its row, so a tap (dy, dx) is one byte
//     offset per lane; rows of the last M tile past the real count read a
//     real position and are dropped in the epilogue;
//   * the warps form a (WM1 + WM2) x WN grid: warp (i, j) with i < WM1
//     owns conv1's M tiles i, i + WM1, ... (MT1 of them), else conv2's
//     tiles i - WM1, i - WM1 + WM2, ... (MT2), and the block's n8 tiles
//     j*NT .. j*NT+NT-1 (8 output channels each), and walks all of every
//     tap's channels (KC chunks of 16, a template argument, so the walk
//     over the 9 taps is unrolled whole);
//   * streamed weights (C=384): K slabs of KC * 16 channels of one tap,
//     both matrices' rows of the block's channels, 2-3 slab buffers in
//     flight with cp.async, the stream running on across row steps;
//   * every fragment is one ldmatrix from a shared-space address; shared
//     rows are C + 8 (activations) and 9C + 8 or KS + 8 (weights) channels
//     apart, odd multiples of 16 bytes, so the 8 rows of an ldmatrix phase
//     hit distinct banks; what does not change between steps (lane row
//     offsets, epilogue offsets, biases) is reckoned once, before the
//     sweep; the epilogues work on the accumulator registers;
//   * a ragged last column tile, row group and image group are masked, so
//     any H, W and N work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

// The launch plan, computed by ops/fused_block_stencil.py (plan_for) and
// passed by value; the CUDA operator's copy (csrc/egonet_ops_cuda.cpp,
// StencilPlan, from _PLAN_FIELDS there) has the same fields in the same
// order.
struct StencilPlan {
  int tw, rh, nb;      // output columns per tile; rows per step; images
                       // per cluster
  int k, cpc;          // blocks per cluster; output channels per block
  int resident;        // 1: weights resident; 0: streamed in K slabs
  int ks, stages;      // streamed: slab depth (channels), slab buffers
  int kc;              // 16-channel chunks per tap: a warp's (resident) or
                       // a slab's (streamed); a template argument
  int mt1, mt2, nt;    // M tiles of a conv1 and a conv2 warp; n8 tiles
  int wm1, wm2;        // warps along M: of conv1, of conv2
  int wn;              // warps along N (each conv)
  int cp, wp;          // row pitch (channels): activations, weights
  int xp, mp;          // positions per image of an x / mid ring slot
  int ahead;           // steps before its first reader an x row is fetched
  int x_slots, mid_slots;  // ring slots: (ahead + 1) R + 2 x rows, 2R + 2
                           // mid rows
  int x_slot, mid_slot;  // bytes of one x / mid ring slot
  int mid_off, w_off;    // byte offsets of the mid ring and the weights
  int w_bytes;         // one matrix's share (resident) or slab buffer
  int smem;            // dynamic shared memory of one block, bytes
};

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxWarps = 8;
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kSmemLimit = 232448;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Checks the plan against the layout the kernel addresses: (ahead + 1) R +
// 2 x slots from offset 0, 2R + 2 mid slots at mid_off, the weights at
// w_off (two shares, or `stages` slab buffers of both matrices' rows),
// all within the block's shared memory.
__host__ inline bool plan_ok(const StencilPlan& p, int C) {
  if (C % 16 || p.k < 1 || p.k > kMaxCluster || p.cpc * p.k != C ||
      p.cpc % 8 || p.tw < 1 || p.rh < 1 || p.nb < 1 || p.wm1 < 1 ||
      p.wm2 < 1 || p.wn < 1 || (p.wm1 + p.wm2) * p.wn > kMaxWarps ||
      p.wn * p.nt * 8 != p.cpc)
    return false;
  if (p.mt1 != cdiv(cdiv(p.rh * p.nb * (p.tw + 2), 16), p.wm1) ||
      p.mt2 != cdiv(cdiv(p.rh * p.nb * p.tw, 16), p.wm2) || p.cp != C + 8 ||
      p.xp != p.tw + 4 || p.mp != p.tw + 2 ||
      p.ahead < 1 || p.ahead > (p.resident ? 2 : 1) ||
      p.x_slots != (p.ahead + 1) * p.rh + 2 || p.mid_slots != 2 * p.rh + 2)
    return false;
  if ((p.x_slot | p.mid_slot | p.mid_off | p.w_off | p.w_bytes) % 128)
    return false;
  if (size_t(p.x_slot) < size_t(p.nb) * p.xp * p.cp * 2 ||
      size_t(p.mid_slot) < size_t(p.nb) * p.mp * p.cp * 2 ||
      p.mid_off < p.x_slots * p.x_slot ||
      p.w_off < p.mid_off + p.mid_slots * p.mid_slot)
    return false;
  size_t w_end;
  if (p.resident) {
    if (p.ks != 0 || p.stages != 0 || p.kc * 16 != C ||
        p.wp != 9 * C + 8 || size_t(p.w_bytes) < size_t(p.cpc) * p.wp * 2)
      return false;
    w_end = size_t(p.w_off) + 2 * size_t(p.w_bytes);
  } else {
    if (p.ks < 16 || p.kc * 16 != p.ks || C % p.ks ||
        p.stages < 2 || p.stages > 3 || p.wp != p.ks + 8 ||
        size_t(p.w_bytes) < size_t(2) * p.cpc * p.wp * 2)
      return false;
    w_end = size_t(p.w_off) + size_t(p.stages) * p.w_bytes;
  }
  return size_t(p.smem) == w_end && p.smem <= kSmemLimit;
}

// ring slot of row r >= -4n in a ring of n slots
__device__ __forceinline__ int ring(int r, int n) { return (r + 4 * n) % n; }

// Start copying x row r (columns tx0-2 .. tx0+TW+1 of images n0 ..
// n0+NB-1, all C channels) into the x ring slot at shared address `slot`;
// positions outside the image or past the batch are zero-filled.
__device__ __forceinline__ void fetch_x_row(unsigned slot,
                                            const bf16* __restrict__ x, int r,
                                            int n0, int tx0, int N, int H,
                                            int W, int C,
                                            const StencilPlan& p) {
  const int cvec = C / 8;  // 16-byte vectors per position
  const int total = p.nb * p.xp * cvec;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int v = i % cvec, pos = i / cvec;
    const int nb = pos / p.xp, xc = pos % p.xp;
    const int n = n0 + nb, gx = tx0 - 2 + xc;
    const bool valid = n < N && r >= 0 && r < H && gx >= 0 && gx < W;
    const bf16* src = valid ? x + ((size_t(n) * H + r) * W + gx) * C + v * 8
                            : x;
    cp_async16(slot + (pos * p.cp + v * 8) * 2, src, valid);
  }
}

// Start copying rows co0 .. co0+cpc-1, columns [k0, k0 + kn), of the
// [C][9C] weight matrix `w` into shared rows `wp` channels apart at `dst`.
__device__ __forceinline__ void fetch_weights(unsigned dst,
                                              const bf16* __restrict__ w,
                                              int co0, int cpc, int C, int k0,
                                              int kn, int wp) {
  const int vec = kn / 8;
  const size_t k9 = size_t(9) * C;
  for (int i = threadIdx.x; i < cpc * vec; i += blockDim.x) {
    const int r = i / vec, v = i % vec;
    cp_async16_all(dst + (r * wp + v * 8) * 2,
                   w + (co0 + r) * k9 + k0 + v * 8);
  }
}

// B fragments of NT n8 tiles (16 K columns) from shared weight rows: an
// x4 ldmatrix per pair of tiles, an x2 for an odd last one.  `addr` is the
// lane's row address in the first tile (row lane % 8 + 8 * (lane / 16), k
// half (lane / 8) % 2); `tile` the bytes between two n8 tiles.
template <int NT>
__device__ __forceinline__ void load_b(unsigned addr, unsigned tile,
                                       unsigned (&b)[NT][2]) {
#pragma unroll
  for (int q = 0; q + 1 < NT; q += 2) {
    unsigned r[4];
    ldsm_x4(addr + q * tile, r);
    b[q][0] = r[0];
    b[q][1] = r[1];
    b[q + 1][0] = r[2];
    b[q + 1][1] = r[3];
  }
  if constexpr (NT % 2 == 1) {
    unsigned r[2];
    ldsm_x2(addr + (NT - 1) * tile, r);
    b[NT - 1][0] = r[0];
    b[NT - 1][1] = r[1];
  }
}

// One K step (16 channels) of tap row `dy`: the warp's MT M tiles (lane
// row address a[i][dy] + off) against its NT n8 tiles of B fragments at wb.
template <int MT, int NT>
__device__ __forceinline__ void k_step(float (&acc)[MT][NT][4],
                                       const unsigned (&a)[MT][3], int dy,
                                       unsigned off, unsigned wb,
                                       unsigned tile) {
  unsigned b[NT][2];
  load_b<NT>(wb, tile, b);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    unsigned f[4];
    ldsm_x4(a[i][dy] + off, f);
#pragma unroll
    for (int q = 0; q < NT; ++q) mma16816(acc[i][q], f, b[q][0], b[q][1]);
  }
}

// The K walk of one step over a resident weight share (at wb, lane and
// warp offsets included): every tap, KC chunks of 16 channels, fully
// unrolled.  a holds each lane's row address in the ring
// slot of tap row dy = 0, 1, 2.
template <int MT, int NT, int KC>
__device__ __forceinline__ void walk_resident(float (&acc)[MT][NT][4],
                                              const unsigned (&a)[MT][3],
                                              unsigned wb, unsigned tile,
                                              int C, int CP) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const unsigned dxo = unsigned((tap % 3) * CP * 2);
    const unsigned wt = unsigned(tap * C * 2);
#pragma unroll
    for (int j = 0; j < KC; ++j)
      k_step<MT, NT>(acc, a, tap / 3, dxo + j * 32, wb + wt + j * 32, tile);
  }
}

// Where the slab stream stands: the buffer to read next, the buffer and
// slab index to fetch next.
struct SlabStream {
  unsigned cur, fetch;
  int next;
};

// The K walk of one step over streamed weights (every thread must call
// it): every slab of every tap through the slab buffers, the first stages
// - 1 already in flight; the copies issued before the call (the next x
// rows) join the first slab's group.  A slab buffer holds W1's rows of
// the block's channels, then W2's (at w2o); the warp reads its conv's at
// b_off (lane and warp offsets included).
template <int MT, int NT, int KC>
__device__ __forceinline__ void walk_streamed(
    float (&acc)[MT][NT][4], const unsigned (&a)[MT][3], unsigned b_off,
    unsigned w2o, unsigned tile, const bf16* __restrict__ w1,
    const bf16* __restrict__ w2, int co0, int C, const StencilPlan& p,
    unsigned slabs, SlabStream& st) {
  constexpr int KS = KC * 16;
  const int per_tap = C / KS, n_slabs = 9 * per_tap;
  const unsigned slab_end = slabs + unsigned(p.stages * p.w_bytes);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const unsigned dxo = unsigned((tap % 3) * p.cp * 2);
    for (int q = 0; q < per_tap; ++q) {
      // this slab has landed, and every warp is done with the buffer the
      // next fetch reuses
      cp_async_wait_slab(p.stages);
      __syncthreads();
      fetch_weights(st.fetch, w1, co0, p.cpc, C, st.next * KS, KS, p.wp);
      fetch_weights(st.fetch + w2o, w2, co0, p.cpc, C, st.next * KS, KS,
                    p.wp);
      cp_async_commit();
      st.next = st.next + 1 == n_slabs ? 0 : st.next + 1;
      st.fetch = st.fetch + p.w_bytes == slab_end ? slabs
                                                   : st.fetch + p.w_bytes;
      const unsigned ao = dxo + unsigned(q * KS * 2);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        k_step<MT, NT>(acc, a, tap / 3, ao + kk * 32,
                       st.cur + b_off + kk * 32, tile);
      st.cur = st.cur + p.w_bytes == slab_end ? slabs : st.cur + p.w_bytes;
    }
  }
}

// What a warp's sweep needs besides the plan: pointers, sizes, where its
// cluster and block sit, and its place in the warp grid.
struct Sweep {
  const bf16* __restrict__ x;
  const bf16* __restrict__ w1;
  const bf16* __restrict__ w2;
  const float* __restrict__ bias;  // of the warp's conv
  bf16* __restrict__ y;
  int N, H, W, C;
  int tx0, n0, co0;   // first column, image and output channel
  int lane, mi, wn_i;  // lane; M index within the warp's conv, N index
};

// The sweep as one warp of conv CONV runs it (every thread of the block
// runs one, conv1's or conv2's, and both pass the same barriers): step s
// fetches the x rows of step s + ahead, computes mid rows m0 .. m0+R-1
// (conv 1; m0 = R(s-1)) or output rows y0 .. y0+R-1 (conv 2; y0 =
// R(s-2)-1), passes the new mid rows to the cluster's other blocks, and
// ends in a barrier of the cluster (of the block where the cluster is one
// block).
template <int CONV, int MT, int NT, int KC, int STREAM>
__device__ __forceinline__ void sweep(const Sweep& w, const StencilPlan& p,
                                      unsigned char* smem, SlabStream st) {
  const unsigned base = smem_addr(smem);
  const unsigned ms0 = base + p.mid_off;  // mid ring
  const unsigned wsh = base + p.w_off;    // weight shares or slab buffers
  const int R = p.rh, CP = p.cp, H = w.H, W = w.W, C = w.C;
  const int xs = p.x_slots, ms = p.mid_slots, lane = w.lane;
  // GEMM row columns: conv 2's TW output columns; conv 1's TW + 2 mid
  // columns, or, where the tile spans the image (one column tile, W <=
  // TW), only the W inside it (mid columns 1 .. W; the halo stays zero)
  const bool whole = CONV == 1 && W <= p.tw;
  const int cols = CONV == 1 ? (whole ? W : p.tw + 2) : p.tw;
  const int c0 = whole ? 1 : 0;                   // column of GEMM column 0
  const int m_real = R * p.nb * cols;             // real GEMM rows
  const int slots = CONV == 1 ? xs : ms;          // of the ring A reads
  const int slot_bytes = CONV == 1 ? p.x_slot : p.mid_slot;
  const unsigned ring0 = CONV == 1 ? base : ms0;

  // what does not change from step to step, reckoned once: per M tile,
  // the lane's A row (its row within the step's R rows and its position
  // offset within a ring slot; a tile past the real rows reads the last
  // real row); per accumulator row, where the
  // epilogue puts it; B fragment offsets; the biases of the warp's
  // channels
  int rr[MT];
  unsigned pos[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = min((w.mi + i * (CONV == 1 ? p.wm1 : p.wm2)) * 16 +
                          lane % 16,
                      m_real - 1);
    const int c = r % (p.nb * cols);
    rr[i] = r / (p.nb * cols);
    pos[i] = unsigned(((c / cols) * (CONV == 1 ? p.xp : p.mp) + c % cols +
                       c0) *
                      CP * 2) +
             (lane / 16) * 16;
  }
  const int ch = (w.wn_i * NT) * 8 + 2 * (lane % 4);  // + 8q: lane's pair
  // accumulator rows: step row (-1: not a real row, or conv 2's past the
  // image or batch) and, conv 1, the mid-slot byte offset of the lane's
  // channel pair and whether the column is inside the image; conv 2, the
  // element offset of the output (and its residual in x) in row 0
  int er[MT][2];
  size_t eo[MT][2];
  bool ein[MT][2] = {};
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int r = (w.mi + i * (CONV == 1 ? p.wm1 : p.wm2)) * 16 +
                    lane / 4 + 8 * e2;
      const int c = r % (p.nb * cols), nb = c / cols, col = c % cols + c0;
      if (CONV == 1) {
        er[i][e2] = r < m_real ? r / (p.nb * cols) : -1;
        eo[i][e2] = size_t(((nb * p.mp + col) * CP + w.co0 + ch) * 2);
        ein[i][e2] = w.tx0 - 1 + col >= 0 && w.tx0 - 1 + col < W;
      } else {
        const bool ok = r < m_real && w.n0 + nb < w.N && w.tx0 + col < W;
        er[i][e2] = ok ? r / (p.nb * cols) : -1;
        eo[i][e2] =
            (size_t(w.n0 + nb) * H * W + (w.tx0 + col)) * C + w.co0 + ch;
      }
    }
  const unsigned tile = unsigned(8 * p.wp * 2);
  const unsigned b_lane =
      unsigned(((lane % 8 + 8 * (lane / 16)) * p.wp + ((lane / 8) % 2) * 8) *
               2) +
      unsigned(w.wn_i * NT) * tile;
  const unsigned w2o = unsigned(p.cpc * p.wp * 2);  // W2 in a slab buffer
  float2 bias[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q)
    bias[q] = *reinterpret_cast<const float2*>(w.bias + w.co0 + ch + 8 * q);

  const int steps = cdiv(H + 1, R) + 1;
  for (int s = 1; s <= steps; ++s) {
    for (int r = R * (s + p.ahead - 1) + 1; r <= min(R * (s + p.ahead), H);
         ++r)
      fetch_x_row(base + ring(r, xs) * p.x_slot, w.x, r, w.n0, w.tx0, w.N, H,
                  W, C, p);
    if constexpr (STREAM == 0) cp_async_commit();
    const int m0 = R * (s - 1), y0 = R * (s - 2) - 1;
    // ring slot of tap row 0 of step row 0 (row m0 - 1 of x, row y0 - 1 of
    // mid); a later row of the step is at most R + 1 slots on, which wraps
    // at most once
    const int sb = ring(CONV == 1 ? m0 - 1 : y0 - 1, slots);
    unsigned a[MT][3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int k = sb + rr[i] + dy;
        a[i][dy] = ring0 + pos[i] +
                   unsigned((k >= slots ? k - slots : k) * slot_bytes);
      }
    // conv 2: the residuals of this step's output rows, loaded from x (in
    // L2: the rows' copies into the ring brought them there) before the
    // walk, so their latency hides behind it
    unsigned res[MT][2][NT];
    if constexpr (CONV == 2) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int yr = y0 + er[i][e2];
          const bool ok = er[i][e2] >= 0 && yr >= 0 && yr < H;
          const unsigned* src = reinterpret_cast<const unsigned*>(
              w.x + eo[i][e2] + size_t(ok ? yr : 0) * W * C);
#pragma unroll
          for (int q = 0; q < NT; ++q)
            res[i][e2][q] = ok ? __ldg(src + 4 * q) : 0u;
        }
    }
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.0f;
    if constexpr (STREAM == 0) {
      // a warp whose tiles all lie past the real rows (conv 1 where a tile
      // spans the image) has nothing to walk
      if (w.mi * 16 < m_real)
        walk_resident<MT, NT, KC>(
            acc, a,
            wsh + (CONV == 1 ? 0u : unsigned(p.w_bytes)) + b_lane, tile, C,
            CP);
    } else
      walk_streamed<MT, NT, KC>(acc, a, b_lane + (CONV == 1 ? 0u : w2o), w2o,
                                tile, w.w1, w.w2, w.co0, C, p, wsh, st);

    // accumulator element e of an n8 tile: row lane / 4 + 8 * (e / 2),
    // channel 2 * (lane % 4) + e % 2
    const int rw = ring(CONV == 1 ? m0 : y0, CONV == 1 ? ms : xs);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int rs = er[i][e2];
        if (rs < 0) continue;
        if (CONV == 1) {
          // conv1 + b1 + relu into the block's channels of mid row m0 +
          // rs of its ring; zero outside the image (conv2's zero
          // padding; rows H and past it)
          const bool in = ein[i][e2] && m0 + rs < H;
          const int k = rw + rs;
          unsigned char* at = smem + p.mid_off +
                              (k >= ms ? k - ms : k) * p.mid_slot +
                              eo[i][e2];
#pragma unroll
          for (int q = 0; q < NT; ++q)
            *reinterpret_cast<__nv_bfloat162*>(at + 16 * q) =
                __floats2bfloat162_rn(
                    in ? fmaxf(acc[i][q][2 * e2] + bias[q].x, 0.0f) : 0.0f,
                    in ? fmaxf(acc[i][q][2 * e2 + 1] + bias[q].y, 0.0f)
                       : 0.0f);
        } else {
          // conv2 + b2 + residual + relu into output row y0 + rs
          const int yr = y0 + rs;
          if (yr < 0 || yr >= H) continue;
          bf16* out = w.y + eo[i][e2] + size_t(yr) * W * C;
#pragma unroll
          for (int q = 0; q < NT; ++q) {
            const float2 rv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&res[i][e2][q]));
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * q) =
                __floats2bfloat162_rn(
                    fmaxf(acc[i][q][2 * e2] + bias[q].x + rv.x, 0.0f),
                    fmaxf(acc[i][q][2 * e2 + 1] + bias[q].y + rv.y, 0.0f));
          }
        }
      }
    }
    if (p.k > 1) {
      // the block's channels of mid rows m0 .. m0+R-1 into every other
      // block of the cluster, 16 bytes a store, by every thread
      __syncthreads();
      const int vec = p.cpc / 8, per_row = p.nb * p.mp * vec;
      const int total = R * per_row * (p.k - 1);
      const unsigned rank = unsigned(w.co0 / p.cpc);
      const int mw = ring(m0, ms);
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int j = i % (R * per_row), peer = i / (R * per_row);
        const int k = mw + j / per_row, v = j % per_row;
        const unsigned off =
            unsigned((k >= ms ? k - ms : k) * p.mid_slot +
                     ((v / vec) * CP + w.co0 + (v % vec) * 8) * 2);
        st_cluster_v4(map_shared_rank(ms0 + off,
                                      (rank + 1 + peer) % unsigned(p.k)),
                      *reinterpret_cast<const uint4*>(smem + p.mid_off + off));
      }
    }
    // the x rows of step s+1 have landed (resident: waited for here;
    // streamed: inside the walk)
    if constexpr (STREAM == 0) {
      if (p.ahead == 2)
        cp_async_wait_group<1>();
      else
        cp_async_wait_all();
    }
    if (p.k == 1)
      __syncthreads();
    else
      cluster_sync();
  }
}

// STREAM == 0: weights resident; 1: streamed in slabs of KC * 16 channels.
// MT1 / MT2: M tiles of a conv1 / conv2 warp.
template <int MT1, int MT2, int NT, int KC, int STREAM>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
fused_basic_block_stencil_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ w1,
                                 const float* __restrict__ b1,
                                 const bf16* __restrict__ w2,
                                 const float* __restrict__ b2,
                                 bf16* __restrict__ y, int N, int H, int W,
                                 int C, StencilPlan p, int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned base = smem_addr(smem);
  const unsigned wsh = base + p.w_off;  // weight shares or slab buffers
  const int warp = threadIdx.x / 32;
  const int wm_i = warp % (p.wm1 + p.wm2);
  const int cluster = blockIdx.x / p.k;
  Sweep w;
  w.x = x;
  w.w1 = w1;
  w.w2 = w2;
  w.y = y;
  w.N = N;
  w.H = H;
  w.W = W;
  w.C = C;
  w.tx0 = (cluster % tiles_x) * p.tw;
  w.n0 = (cluster / tiles_x) * p.nb;
  w.co0 = int(cluster_ctarank()) * p.cpc;
  w.lane = threadIdx.x % 32;
  w.wn_i = warp / (p.wm1 + p.wm2);

  // 1. the weights (resident: the block's whole share, once), x rows -1
  //    .. ahead R, the first slabs (streamed), and a zero mid ring
  if constexpr (STREAM == 0) {
    fetch_weights(wsh, w1, w.co0, p.cpc, C, 0, 9 * C, p.wp);
    fetch_weights(wsh + p.w_bytes, w2, w.co0, p.cpc, C, 0, 9 * C, p.wp);
  }
  for (int r = -1; r <= min(p.ahead * p.rh, H); ++r)
    fetch_x_row(base + ring(r, p.x_slots) * p.x_slot, x, r, w.n0, w.tx0, N,
                H, W, C, p);
  cp_async_commit();
  SlabStream st{wsh, wsh, 0};
  if constexpr (STREAM == 1) {
    const unsigned w2o = unsigned(p.cpc * p.wp * 2);
    for (int j = 0; j < p.stages - 1; ++j) {
      fetch_weights(st.fetch, w1, w.co0, p.cpc, C, j * p.ks, p.ks, p.wp);
      fetch_weights(st.fetch + w2o, w2, w.co0, p.cpc, C, j * p.ks, p.ks,
                    p.wp);
      cp_async_commit();
      st.fetch += p.w_bytes;
    }
    st.next = p.stages - 1;
  }
  {
    // mid row -1, and the halo columns no conv1 row writes, are zero
    uint4* z = reinterpret_cast<uint4*>(smem + p.mid_off);
    for (int i = threadIdx.x; i < p.mid_slots * p.mid_slot / 16;
         i += blockDim.x)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // every block of the cluster has started (its shared memory may be
  // written) and the first copies have landed
  cp_async_wait_all();
  cluster_sync();

  // 2. the sweep, by conv1's warps and conv2's
  if (wm_i < p.wm1) {
    w.mi = wm_i;
    w.bias = b1;
    sweep<1, MT1, NT, KC, STREAM>(w, p, smem, st);
  } else {
    w.mi = wm_i - p.wm1;
    w.bias = b2;
    sweep<2, MT2, NT, KC, STREAM>(w, p, smem, st);
  }
  cp_async_wait_all();
}

template <int MT1, int MT2, int NT, int KC, int STREAM>
int launch(bool query, int* clusters, const void* x, const void* w1,
           const void* b1, const void* w2, const void* b2, void* y, int N,
           int H, int W, int C, const StencilPlan& p, cudaStream_t stream) {
  auto kernel = fused_basic_block_stencil_kernel<MT1, MT2, NT, KC, STREAM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return int(err);
  const int tiles_x = cdiv(W, p.tw);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(tiles_x * cdiv(N, p.nb) * p.k));
  cfg.blockDim = dim3(unsigned((p.wm1 + p.wm2) * p.wn * 32));
  cfg.dynamicSmemBytes = size_t(p.smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (query)
    return int(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(y), N, H, W, C, p,
      tiles_x);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

int dispatch(bool query, int* clusters, const void* x, const void* w1,
             const void* b1, const void* w2, const void* b2, void* y, int N,
             int H, int W, int C, const StencilPlan& p, cudaStream_t s) {
#define EGONET_VARIANT(MT1_, MT2_, NT_, KC_, STREAM_)                     \
  if (p.mt1 == MT1_ && p.mt2 == MT2_ && p.nt == NT_ && p.kc == KC_ &&      \
      p.resident == 1 - STREAM_)                                          \
    return launch<MT1_, MT2_, NT_, KC_, STREAM_>(query, clusters, x, w1, b1, \
                                                 w2, b2, y, N, H, W, C, p, s);
  EGONET_VARIANTS
#undef EGONET_VARIANT
  return int(cudaErrorInvalidValue);
}

}  // namespace

// The (MT1, MT2, NT, KC, STREAM) instantiations this library holds come
// from the build: ops/fused_block_stencil.py (library) lists those of its
// launch plans as EGONET_VARIANTS, a run of EGONET_VARIANT(MT1, MT2, NT,
// KC, STREAM), in
// a prelude that ops/_build.py includes before this file.
#ifndef EGONET_VARIANTS
#error "EGONET_VARIANTS is undefined: build through egonet_tpu_torch/ops/_build.py"
#endif

extern "C" {

// Launch on `stream` with the plan `p` as one cluster of p.k blocks per
// (column tile, image group); returns the launch's error (0 on success),
// or cudaErrorInvalidValue for a plan the kernel cannot run or this library
// does not hold.  All pointers must be 16-byte aligned (the caller checks).
int egonet_fused_basic_block_stencil(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* y, int N, int H,
                                     int W, int C, StencilPlan p,
                                     void* stream) {
  if (N < 1 || H < 1 || W < 1 || !plan_ok(p, C))
    return int(cudaErrorInvalidValue);
  return dispatch(false, nullptr, x, w1, b1, w2, b2, y, N, H, W, C, p,
                  static_cast<cudaStream_t>(stream));
}

// How many clusters of the plan the card can hold at once
// (cudaOccupancyMaxActiveClusters) into *clusters; returns the error.
int egonet_fused_basic_block_stencil_clusters(int C, StencilPlan p,
                                              int* clusters) {
  *clusters = 0;
  if (!plan_ok(p, C)) return int(cudaErrorInvalidValue);
  return dispatch(true, clusters, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, 1, 1, p.tw, C, p, nullptr);
}

}  // extern "C"
