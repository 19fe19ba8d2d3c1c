// Exact flash attention for Hopper (sm_90a): forward, and a deterministic
// two-kernel backward (dK/dV, then dQ). bf16 inputs, fp32 accumulation.
//
// Replaces the Pallas TPU kernels of dedloc_tpu/ops/flash_attention.py:
//   flash_fwd_kernel       <- _fwd_kernel (via _fwd, the pallas_call at :143)
//   flash_bwd_dkdv_kernel  <- _dkv_kernel (split backward, pallas_call at :327)
//   flash_bwd_dq_kernel    <- _dq_kernel (split backward, pallas_call at :309)
//   and the pair together  <- _dqkv_fused_kernel (the single-tile backward,
//                             pallas_call at :361)
//
// Layout: q, k, v, out, dO, dq, dk, dv are [B, S, H, D] read through their
// strides (the last dimension contiguous); the bias is a per-key additive
// [B, S] row indexed by bh / H; lse and delta are [B*H, S] fp32.
//
// Numerics follow the TPU kernel: s = (q.k) * scale + bias in fp32; the
// running max starts at -1e30 with no -inf special case, so a row whose keys
// are all masked by a finite -1e9 bias averages V uniformly (and in the
// backward s - lse is 0 there, so p = 1 for every key); p is rounded to bf16
// before p.V; out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30));
// ds = p * (dp - delta) * scale is rounded to bf16 before ds.K and ds^T.Q.
// Keys or queries past S in the last (ragged) tile get probability exactly 0;
// their outputs are not written.
//
// All three kernels share one block shape. A block is three warpgroups: one
// producer warp and two consumer warpgroups of 64 resident rows each
// (setmaxnreg moves registers from the producer to the consumers). The
// resident tile (Q for the forward and dQ, K and V for dK/dV; 128 rows) is
// loaded once by TMA and stays in shared memory; the streamed tiles arrive
// through a ring of STAGES buffers filled by TMA (cp.async.bulk.tensor, 4-D
// tensor maps over (D, H, S, B) built from the strides, zero fill past S)
// and handed over with mbarriers, so the copy of the next tiles overlaps the
// products on the current one; the fp32 rows (bias, lse, delta) are loaded
// by the producer's lanes, with bias -inf (keys) or lse +inf (queries) past
// S, so p is exactly 0 there. Every product is a warpgroup wgmma (m64nNk16,
// bf16 x bf16 -> fp32), the only instruction that reaches the tensor cores'
// full rate: score products read both operands from shared memory
// (K-major); the products with P (or P^T, dS, dS^T) take it from registers,
// converted in place from the fp32 accumulator, and B from a streamed tile
// with the transpose bit (MN-major). Shared tiles use wgmma's swizzled
// layouts (128-byte swizzle at D=64; hopper.cuh). Exps are ex2.approx on
// (s * scale + bias - m) * log2(e), the difference taken first in fp32 as
// the reference does. Each output row has one owner: no atomics, and
// repeated runs are bitwise equal. The blocks of one head are neighbours in
// launch order, so the blocks running together stream that head through L2.
//
// Forward. Per score it does two S x S x D products (S = Q.K^T, O += P.V)
// and one exp, against O(S*D) bytes per head: at [2, 16384, 16, 64] the
// products need 2.22 ms of tensor-core time at 989 TFLOP/s and the exps
// 2.05 ms of the special-function units (16 per clock per SM), so the two
// nearly tie and the kernel is fast only if the exps run while the tensor
// cores work. The TPU grid ran the KV axis sequentially and carried
// (acc, m, l) in VMEM scratch; here each consumer warpgroup keeps O, m and
// l of its 64 query rows in registers and loops over the key tiles (BK
// keys, streamed with the bias row) with an online softmax. Two schedules
// overlap the exps with the products: within a warpgroup the loop is
// rotated, so iteration j issues S_j = Q.K_j^T and O += P_{j-1}.V_{j-1}
// together and turns S_j into P_j while P_{j-1}.V_{j-1} is still on the
// tensor cores; across warpgroups the two issue their products in turns
// (named barriers), so one's softmax runs while the other's products do.
// With 128-key tiles the two together were the fastest of the schedules
// measured (PERF.md, Findings).
//
// Backward. The fused TPU backward kept one 512x512 fp32 score tile per head
// in VMEM (1 MB), which does not fit in 227 KB of shared memory, so the
// backward is two kernels that recompute p = exp(s - lse): dK/dV with one
// block per 128-key tile looping over 64-query tiles, and dQ with one block
// per 128-query tile looping over 64-key tiles.
// - What bounds them: operations. Per score, dK/dV does 4 products (S^T =
//   K.Q^T, dP^T = V.dO^T, dV += P^T.dO, dK += dS^T.Q) and dQ 3 (S = Q.K^T,
//   dP = dO.V^T, dQ += dS.K), 2 D flops each on the bf16 tensor cores, plus
//   one exp per score on the special-function units; HBM traffic is O(S*D)
//   per head. At [2, 16384, 16, 64] that is 4.45 and 3.34 ms of tensor-core
//   time at 989 TFLOP/s, against ~0.02 ms of bytes.
// - What still holds them back (PERF.md, Findings): the exps (16 per clock per
//   SM) and the other per-score work add to the products instead of hiding
//   behind them; schedules that interleave the two warpgroups or pipeline
//   tiles within one were measured and were no faster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's initial running max
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 = 384 x 168 registers
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use (227 KB)

// element strides of a [B, S, H, D] tensor whose last dimension is contiguous
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float neg_infinity() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float pos_infinity() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment (mma.sync's A layout per warp) of 16 columns [16 kk, +16)
// of a C-layout strip of J 8-column groups
template <int J>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[J][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// bf16 columns per swizzled column chunk of a D-wide tile (hopper.cuh)
template <int D>
__host__ __device__ constexpr int chunk_width() {
  return D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
}

// Shared memory of a block, from a 1024-byte aligned base: NRES resident
// tiles of RES rows (the first D0 wide, the second D1), STAGES ring slots of
// two streamed tiles of STREAM rows (D0 wide, then D1) and NROWS fp32 rows
// of STREAM, then the mbarriers.
template <int D0_, int D1_, int NRES_, int STREAM_, int STAGES_, int NROWS_>
struct Ring {
  static constexpr int D0 = D0_;  // q/k side
  static constexpr int D1 = D1_;  // v/dO side
  static constexpr int NRES = NRES_;
  static constexpr int RES = 128;  // resident rows: one 64-row slab per consumer warpgroup
  static constexpr int STREAM = STREAM_;  // rows per streamed tile
  static constexpr int STAGES = STAGES_;
  static constexpr int NROWS = NROWS_;
  static constexpr int RES_BYTES0 = RES * D0 * 2;
  static constexpr int RES_BYTES1 = RES * D1 * 2;
  static constexpr int TILE_BYTES0 = STREAM * D0 * 2;
  static constexpr int TILE_BYTES1 = STREAM * D1 * 2;
  static constexpr int SLOT_BYTES = TILE_BYTES0 + TILE_BYTES1;
  static constexpr int OFF_STREAM = RES_BYTES0 + (NRES == 2 ? RES_BYTES1 : 0);
  static constexpr int OFF_ROWS = OFF_STREAM + STAGES * SLOT_BYTES;
  static constexpr int OFF_BARS = OFF_ROWS + STAGES * NROWS * STREAM * 4;
  static constexpr int SMEM = OFF_BARS + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
  static_assert(RES_BYTES0 % 1024 == 0 && RES_BYTES1 % 1024 == 0 && TILE_BYTES0 % 1024 == 0 &&
                    TILE_BYTES1 % 1024 == 0,
                "swizzle alignment");
  static_assert(STREAM % 64 == 0, "streamed tiles are loaded as 64-row boxes");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

// the backward: two resident tiles, 64-row tiles of two tensors and two rows
template <int DQK, int DV>
using Bwd = Ring<DQK, DV, 2, 64, 3, 2>;

// The forward: Q resident, FWD_BK-key tiles of K and V and the bias row, as
// many stages as fit (at most 4): Ring's layout is Q, the res barrier and
// the alignment slack, then per stage K, V, the bias row and two barriers.
constexpr int FWD_BK = 128;

template <int DQK, int DV>
constexpr int fwd_stages() {
  const int fit = (SMEM_LIMIT - (128 * DQK * 2 + 8 + 1024)) /
                  (FWD_BK * (DQK + DV) * 2 + FWD_BK * 4 + 16);
  return fit < 4 ? fit : 4;
}

template <int DQK, int DV>
using Fwd = Ring<DQK, DV, 1, FWD_BK, fwd_stages<DQK, DV>(), 1>;

// The block's shared memory and barriers: full[s] (the producer warp's 32
// arrivals plus the TMA bytes of slot s), empty[s] (every consumer thread
// done with slot s), res (the resident tiles' TMA bytes).
template <typename C>
struct RingSmem {
  uint32_t base;
  float* rows;
  __device__ explicit RingSmem(unsigned char* raw_ptr) {
    const uint32_t raw = hopper::smem_addr(raw_ptr);
    base = (raw + 1023u) & ~1023u;
    rows = reinterpret_cast<float*>(raw_ptr + (base - raw) + C::OFF_ROWS);
  }
  __device__ uint32_t res(int i) const { return base + i * C::RES_BYTES0; }
  __device__ uint32_t tile(int slot, int i) const {
    return base + C::OFF_STREAM + slot * C::SLOT_BYTES + i * C::TILE_BYTES0;
  }
  __device__ float* row(int slot, int i) const { return rows + (C::NROWS * slot + i) * C::STREAM; }
  __device__ uint32_t full(int slot) const { return base + C::OFF_BARS + 8 * slot; }
  __device__ uint32_t empty(int slot) const {
    return base + C::OFF_BARS + 8 * (C::STAGES + slot);
  }
  __device__ uint32_t res_bar() const { return base + C::OFF_BARS + 8 * 2 * C::STAGES; }

  __device__ void init_barriers() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < C::STAGES; ++s) {
        hopper::mbar_init(full(s), 32);
        hopper::mbar_init(empty(s), 2 * 128);
      }
      hopper::mbar_init(res_bar(), 1);
      hopper::mbar_fence_init();
    }
    __syncthreads();
  }
};

// rows [row0, row0 + ROWS) of head (b, h) of a DW-wide tensor into the
// tile at dst, as 64-row boxes per column chunk (one thread)
template <int DW, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int b, int h, int row0) {
  constexpr int CW = chunk_width<DW>();
#pragma unroll
  for (int c = 0; c < DW / CW; ++c)
#pragma unroll
    for (int box = 0; box < ROWS / 64; ++box)
      hopper::tma_load_4d(dst + c * ROWS * CW * 2 + box * 64 * CW * 2, map, bar, c * CW, h,
                          row0 + 64 * box, b);
}

// rows [row0, row0 + 128) of head (b, h) of the NRES tensors (m0, D0 wide,
// then m1, D1 wide) into the resident tiles (one thread)
template <typename C>
__device__ __forceinline__ void load_resident(const RingSmem<C>& sm, const CUtensorMap* m0,
                                              const CUtensorMap* m1, int b, int h, int row0) {
  hopper::mbar_expect_tx(sm.res_bar(), C::RES_BYTES0 + (C::NRES == 2 ? C::RES_BYTES1 : 0));
  load_tile<C::D0, C::RES>(sm.res(0), m0, sm.res_bar(), b, h, row0);
  if constexpr (C::NRES == 2) load_tile<C::D1, C::RES>(sm.res(1), m1, sm.res_bar(), b, h, row0);
  hopper::mbar_arrive(sm.res_bar());
}

// rows [row0, row0 + STREAM) of head (b, h) of two tensors (D0 wide, then
// D1) into ring slot s (one thread; the slot's full barrier counts the bytes)
template <typename C>
__device__ __forceinline__ void load_stream(const RingSmem<C>& sm, int s, const CUtensorMap* m0,
                                            const CUtensorMap* m1, int b, int h, int row0) {
  hopper::mbar_expect_tx(sm.full(s), C::SLOT_BYTES);
  load_tile<C::D0, C::STREAM>(sm.tile(s, 0), m0, sm.full(s), b, h, row0);
  load_tile<C::D1, C::STREAM>(sm.tile(s, 1), m1, sm.full(s), b, h, row0);
}

// S (or S^T, dP, dP^T) = rows [64 w, +64) of a resident tile . (a streamed
// tile)^T over their common width DW: one wgmma per 16 columns, both
// operands K-major
template <typename C, int DW>
__device__ __forceinline__ void score_product(float (&acc)[C::STREAM / 2], uint32_t res, int w,
                                              uint32_t tile) {
  constexpr int CW = chunk_width<DW>();
#pragma unroll
  for (int kk = 0; kk < DW / 16; ++kk)
    hopper::wgmma_ss<C::STREAM>(acc, hopper::desc_kmajor<CW, C::RES>(res, 64 * w, kk),
                                hopper::desc_kmajor<CW, C::STREAM>(tile, 0, kk), kk > 0);
}

// acc[64 x DW] += A[64 x STREAM] (registers) . (a streamed tile, STREAM x DW)
template <typename C, int DW>
__device__ __forceinline__ void grad_product(float (&acc)[DW / 2],
                                             const uint32_t (&a)[C::STREAM / 16][4],
                                             uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < C::STREAM / 16; ++kk)
    hopper::wgmma_rs_t_wide<DW, chunk_width<DW>(), C::STREAM>(acc, a[kk], tile, kk);
}

// the A fragments (K = N in steps of 16) of a 64 x N wgmma accumulator,
// rounded to bf16: per warp the accumulator has mma.sync's C layout and
// wgmma's register A has mma.sync's A layout
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
  const auto& strip = reinterpret_cast<const float(&)[N / 8][4]>(c);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) c_to_a(a[kk], strip, kk);
}

// a consumer thread's two rows (g and g + 8 of its warp's 16) of a 64 x D
// accumulator as bf16; rows at or past S are not written
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 2], int row_g, int S, bf16* dst,
                                          Strides st, int b, int h) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_g + 8 * half;
    if (row >= S) continue;
    bf16* out = dst + b * st.b + (long long)row * st.s + h * st.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * t) =
          pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

// The block's (head, tile): the tiles of one head go to neighbouring blocks,
// so the blocks running together stream the same head's tiles through L2.
// ``last_first`` numbers the tiles from the last (a causal forward or dQ,
// whose last tiles have the most keys, launches them first).
__device__ __forceinline__ void block_tile(int& bh, int& tile, bool last_first = false) {
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  tile = lin % gridDim.y;
  if (last_first) tile = gridDim.y - 1 - tile;
  bh = lin / gridDim.y;
}

// ---------------------------------------------------------------- forward

// The online softmax of one BK-key tile for a consumer thread's two rows:
// s = acc * scale + bias, m_new = max(m, rowmax s), p = exp(s - m_new) in
// place, corr = exp(m - m_new); l (this thread's share of the row sum) =
// l * corr + sum p. Keys past S have bias -inf and get p = 0; with MASK
// (the causal diagonal tile) so does a key past the row (key0 is the tile's
// first key, row the thread's first row, row + 8 its second).
template <int BK, bool MASK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], const float* r_bias,
                                               float scale, float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int key0, int row) {
  const int t = threadIdx.x % 4;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float2 kb = *reinterpret_cast<const float2*>(r_bias + 8 * j + 2 * t);
    sc[4 * j + 0] = fmaf(sc[4 * j + 0], scale, kb.x);
    sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale, kb.y);
    sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale, kb.x);
    sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale, kb.y);
    if constexpr (MASK) {
      const int k = key0 + 8 * j + 2 * t;
      if (k > row) sc[4 * j + 0] = neg_infinity();
      if (k + 1 > row) sc[4 * j + 1] = neg_infinity();
      if (k > row + 8) sc[4 * j + 2] = neg_infinity();
      if (k + 1 > row + 8) sc[4 * j + 3] = neg_infinity();
    }
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    corr[r] = hopper::exp2_approx((m[r] - mx[r]) * LOG2E);
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = hopper::exp2_approx((sc[4 * j + e] - m[e / 2]) * LOG2E);
      sum[e / 2] += sc[4 * j + e];
    }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

// Consumer warpgroup w's turn to issue products: named barrier 1 + w, 128
// threads of w waiting and 128 of the other arriving
__device__ __forceinline__ void turn_wait(int w) { hopper::bar_sync<256>(1 + w); }
__device__ __forceinline__ void turn_pass(int w) { hopper::bar_arrive<256>(2 - w); }

// One block per (batch*head, 128-query tile). The two consumer warpgroups
// issue their products in turns, and each waits only for S_j before its
// softmax, so the softmax runs while P_{j-1}.V_{j-1} is in flight. Causal:
// the key tiles up to the block's own (the last, masked; BK = 128 = RES).
template <int DQK, int DV, bool CAUSAL>
__device__ __forceinline__ void fwd_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                         const CUtensorMap& tm_v, const float* __restrict__ bias,
                                         bf16* __restrict__ out, float* __restrict__ lse,
                                         Strides so, int S, int H, float scale) {
  using C = Fwd<DQK, DV>;
  constexpr int BK = FWD_BK;
  static_assert(BK == C::RES, "the causal diagonal is one key tile");
  extern __shared__ unsigned char smem[];
  const RingSmem<C> sm(smem);
  int bh, qt;
  block_tile(bh, qt, CAUSAL);
  const int b = bh / H, h = bh % H;
  const int q0 = qt * C::RES;
  const int n_tiles = CAUSAL ? (min(S, q0 + C::RES) + BK - 1) / BK : (S + BK - 1) / BK;
  sm.init_barriers();

  if (threadIdx.x < 128) {
    // producer: warp 0 keeps the ring full; the other warps leave
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) load_resident(sm, &tm_q, nullptr, b, h, q0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::STAGES;
      const int k0 = it * BK;
      hopper::mbar_wait(sm.empty(s), ((it / C::STAGES) & 1) ^ 1);
      if (lane == 0) load_stream(sm, s, &tm_k, &tm_v, b, h, k0);
      float* r_bias = sm.row(s, 0);
      for (int i = lane; i < BK; i += 32) {
        const int k = k0 + i;
        // a key past S: bias -inf gives p = 0 for every query
        r_bias[i] = k < S ? bias[(long long)b * S + k] : neg_infinity();
      }
      hopper::mbar_arrive(sm.full(s));
    }
  } else {
    // consumers: warpgroup w owns query rows [q0 + 64 w, +64)
    hopper::regs_inc<CONSUMER_REGS>();
    const int ct = threadIdx.x - 128;
    const int w = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const int row_g = q0 + 64 * w + 16 * warp + lane / 4;  // and row_g + 8

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
    float sc[BK / 2];         // S_j, then P_j in fp32
    uint32_t pa[BK / 16][4];  // P_{j-1} as bf16 A fragments
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, corr[2];

    hopper::mbar_wait(sm.res_bar(), 0);
    if (w == 1) turn_pass(w);  // warpgroup 0 issues first

    // tile 0: S_0 and its softmax
    hopper::mbar_wait(sm.full(0), 0);
    turn_wait(w);
    hopper::wgmma_fence();
    score_product<C, DQK>(sc, sm.res(0), w, sm.tile(0, 0));  // S_0 = Q . K_0^T
    hopper::wgmma_commit();
    turn_pass(w);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    if (CAUSAL && n_tiles == 1)
      online_softmax<BK, true>(sc, sm.row(0, 0), scale, m, l, corr, 0, row_g);
    else
      online_softmax<BK, false>(sc, sm.row(0, 0), scale, m, l, corr, 0, row_g);
    acc_to_a<BK>(pa, sc);

    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % C::STAGES;
      const int prev = (it - 1) % C::STAGES;
      hopper::mbar_wait(sm.full(s), (it / C::STAGES) & 1);
      turn_wait(w);
      hopper::wgmma_fence();
      score_product<C, DQK>(sc, sm.res(0), w, sm.tile(s, 0));  // S_j = Q . K_j^T
      hopper::wgmma_commit();
      grad_product<C, DV>(o, pa, sm.tile(prev, 1));  // O += P_{j-1} . V_{j-1}
      hopper::wgmma_commit();
      turn_pass(w);
      hopper::wgmma_wait<1>();  // S_j only
      hopper::fence_regs(sc);
      if (CAUSAL && it == n_tiles - 1)
        online_softmax<BK, true>(sc, sm.row(s, 0), scale, m, l, corr, it * BK, row_g);
      else
        online_softmax<BK, false>(sc, sm.row(s, 0), scale, m, l, corr, it * BK, row_g);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      hopper::mbar_arrive(sm.empty(prev));
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i % 4) / 2];
      acc_to_a<BK>(pa, sc);
    }

    // the last tile's P.V
    const int last = (n_tiles - 1) % C::STAGES;
    turn_wait(w);
    hopper::wgmma_fence();
    grad_product<C, DV>(o, pa, sm.tile(last, 1));
    hopper::wgmma_commit();
    if (w == 0) turn_pass(w);  // warpgroup 1 issues last
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
    hopper::mbar_arrive(sm.empty(last));

    // out = acc / max(l, 1e-30) (a division, as the TPU kernel),
    // lse = m + log(max(l, 1e-30))
    const float sl[2] = {fmaxf(quad_sum(l[0]), 1e-30f), fmaxf(quad_sum(l[1]), 1e-30f)};
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] /= sl[(i % 4) / 2];
    store_acc<DV>(o, row_g, S, out, so, b, h);
    if (lane % 4 == 0) {
      if (row_g < S) lse[(long long)bh * S + row_g] = m[0] + logf(sl[0]);
      if (row_g + 8 < S) lse[(long long)bh * S + row_g + 8] = m[1] + logf(sl[1]);
    }
  }
}

// ----------------------------------------------------------- backward dK/dV

// Causal: the query tiles from the block's first key on; the two that the
// diagonal crosses are masked.
template <int DQK, int DV, bool CAUSAL>
__device__ __forceinline__ void bwd_dkdv_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                              const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                                              Strides sdk, Strides sdv, int S, int H,
                                              float scale) {
  using C = Bwd<DQK, DV>;
  extern __shared__ unsigned char smem[];
  const RingSmem<C> sm(smem);
  int bh, kt;
  block_tile(bh, kt);
  const int b = bh / H, h = bh % H;
  const int k0 = kt * C::RES;
  const int first = CAUSAL ? k0 / C::STREAM : 0;
  const int n_tiles = (S + C::STREAM - 1) / C::STREAM - first;
  sm.init_barriers();

  if (threadIdx.x < 128) {
    // producer: warp 0 keeps the ring full; the other warps leave
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) load_resident(sm, &tm_k, &tm_v, b, h, k0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::STAGES;
      const int q0 = (first + it) * C::STREAM;
      hopper::mbar_wait(sm.empty(s), ((it / C::STAGES) & 1) ^ 1);
      if (lane == 0) load_stream(sm, s, &tm_q, &tm_do, b, h, q0);
      float* r_lse = sm.row(s, 0);
      float* r_delta = sm.row(s, 1);
      for (int i = lane; i < C::STREAM; i += 32) {
        const int q = q0 + i;
        // a query past S: lse +inf gives p = 0 for every key
        r_lse[i] = q < S ? lse[(long long)bh * S + q] : pos_infinity();
        r_delta[i] = q < S ? delta[(long long)bh * S + q] : 0.0f;
      }
      hopper::mbar_arrive(sm.full(s));
    }
  } else {
    // consumers: warpgroup w owns key rows [k0 + 64 w, +64) of dK and dV
    hopper::regs_inc<CONSUMER_REGS>();
    const int ct = threadIdx.x - 128;
    const int w = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const int g = lane / 4, t = lane % 4;
    const int key0 = k0 + 64 * w + 16 * warp + g, key1 = key0 + 8;
    // a key past S: bias -inf gives p = 0 for every query
    const float kb0 = key0 < S ? bias[(long long)b * S + key0] : neg_infinity();
    const float kb1 = key1 < S ? bias[(long long)b * S + key1] : neg_infinity();

    float acc_dv[DV / 2], acc_dk[DQK / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc_dv[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) acc_dk[i] = 0.0f;

    hopper::mbar_wait(sm.res_bar(), 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::STAGES;
      hopper::mbar_wait(sm.full(s), (it / C::STAGES) & 1);
      const uint32_t sQ = sm.tile(s, 0), sDO = sm.tile(s, 1);
      const float* r_lse = sm.row(s, 0);
      const float* r_delta = sm.row(s, 1);

      float st[32], dpt[32];  // S^T and dP^T: 64 keys x 64 queries
      hopper::wgmma_fence();
      score_product<C, DQK>(st, sm.res(0), w, sQ);  // S^T = K . Q^T
      hopper::wgmma_commit();
      score_product<C, DV>(dpt, sm.res(1), w, sDO);  // dP^T = V . dO^T
      hopper::wgmma_commit();

      hopper::wgmma_wait<1>();
      hopper::fence_regs(st);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(r_lse + 8 * j + 2 * t);
        st[4 * j + 0] = hopper::exp2_approx((fmaf(st[4 * j + 0], scale, kb0) - l.x) * LOG2E);
        st[4 * j + 1] = hopper::exp2_approx((fmaf(st[4 * j + 1], scale, kb0) - l.y) * LOG2E);
        st[4 * j + 2] = hopper::exp2_approx((fmaf(st[4 * j + 2], scale, kb1) - l.x) * LOG2E);
        st[4 * j + 3] = hopper::exp2_approx((fmaf(st[4 * j + 3], scale, kb1) - l.y) * LOG2E);
      }
      if (CAUSAL && (first + it) * C::STREAM < k0 + C::RES) {
        // a query before the key: p = 0
        const int q = (first + it) * C::STREAM + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (q + 8 * j < key0) st[4 * j + 0] = 0.0f;
          if (q + 8 * j + 1 < key0) st[4 * j + 1] = 0.0f;
          if (q + 8 * j < key1) st[4 * j + 2] = 0.0f;
          if (q + 8 * j + 1 < key1) st[4 * j + 3] = 0.0f;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(r_delta + 8 * j + 2 * t);
        dpt[4 * j + 0] = st[4 * j + 0] * (dpt[4 * j + 0] - dl.x) * scale;
        dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - dl.y) * scale;
        dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - dl.x) * scale;
        dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - dl.y) * scale;
      }
      uint32_t pa[4][4], dsa[4][4];  // P^T and dS^T as bf16 A fragments
      acc_to_a<64>(pa, st);
      acc_to_a<64>(dsa, dpt);

      hopper::wgmma_fence();
      grad_product<C, DV>(acc_dv, pa, sDO);  // dV += P^T . dO
      grad_product<C, DQK>(acc_dk, dsa, sQ);  // dK += dS^T . Q
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_dv);
      hopper::fence_regs(acc_dk);
      hopper::fence_regs(pa);
      hopper::fence_regs(dsa);
      hopper::mbar_arrive(sm.empty(s));
    }

    store_acc<DV>(acc_dv, key0, S, dv, sdv, b, h);
    store_acc<DQK>(acc_dk, key0, S, dk, sdk, b, h);
  }
}

// -------------------------------------------------------------- backward dQ

// Causal: the key tiles up to the block's last query; the two that the
// diagonal crosses are masked.
template <int DQK, int DV, bool CAUSAL>
__device__ __forceinline__ void bwd_dq_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                            const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            bf16* __restrict__ dq, Strides sdq, int S, int H,
                                            float scale) {
  using C = Bwd<DQK, DV>;
  extern __shared__ unsigned char smem[];
  const RingSmem<C> sm(smem);
  int bh, qt;
  block_tile(bh, qt, CAUSAL);
  const int b = bh / H, h = bh % H;
  const int q0 = qt * C::RES;
  const int n_tiles = ((CAUSAL ? min(S, q0 + C::RES) : S) + C::STREAM - 1) / C::STREAM;
  sm.init_barriers();

  if (threadIdx.x < 128) {
    // producer: warp 0 keeps the ring full; the other warps leave
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) load_resident(sm, &tm_q, &tm_do, b, h, q0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::STAGES;
      const int k0 = it * C::STREAM;
      hopper::mbar_wait(sm.empty(s), ((it / C::STAGES) & 1) ^ 1);
      if (lane == 0) load_stream(sm, s, &tm_k, &tm_v, b, h, k0);
      float* r_bias = sm.row(s, 0);
      for (int i = lane; i < C::STREAM; i += 32) {
        const int k = k0 + i;
        // a key past S: bias -inf gives p = 0 for every query
        r_bias[i] = k < S ? bias[(long long)b * S + k] : neg_infinity();
      }
      hopper::mbar_arrive(sm.full(s));
    }
  } else {
    // consumers: warpgroup w owns query rows [q0 + 64 w, +64) of dQ
    hopper::regs_inc<CONSUMER_REGS>();
    const int ct = threadIdx.x - 128;
    const int w = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const int g = lane / 4, t = lane % 4;
    const int qr0 = q0 + 64 * w + 16 * warp + g, qr1 = qr0 + 8;
    // a query past S: lse +inf gives p = 0 for every key
    const float lse0 = qr0 < S ? lse[(long long)bh * S + qr0] : pos_infinity();
    const float lse1 = qr1 < S ? lse[(long long)bh * S + qr1] : pos_infinity();
    const float delta0 = qr0 < S ? delta[(long long)bh * S + qr0] : 0.0f;
    const float delta1 = qr1 < S ? delta[(long long)bh * S + qr1] : 0.0f;

    float acc_dq[DQK / 2];
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) acc_dq[i] = 0.0f;

    hopper::mbar_wait(sm.res_bar(), 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::STAGES;
      hopper::mbar_wait(sm.full(s), (it / C::STAGES) & 1);
      const uint32_t sK = sm.tile(s, 0), sV = sm.tile(s, 1);
      const float* r_bias = sm.row(s, 0);

      float sc[32], dp[32];  // S and dP: 64 queries x 64 keys
      hopper::wgmma_fence();
      score_product<C, DQK>(sc, sm.res(0), w, sK);  // S = Q . K^T
      hopper::wgmma_commit();
      score_product<C, DV>(dp, sm.res(1), w, sV);  // dP = dO . V^T
      hopper::wgmma_commit();

      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 kb = *reinterpret_cast<const float2*>(r_bias + 8 * j + 2 * t);
        sc[4 * j + 0] = hopper::exp2_approx((fmaf(sc[4 * j + 0], scale, kb.x) - lse0) * LOG2E);
        sc[4 * j + 1] = hopper::exp2_approx((fmaf(sc[4 * j + 1], scale, kb.y) - lse0) * LOG2E);
        sc[4 * j + 2] = hopper::exp2_approx((fmaf(sc[4 * j + 2], scale, kb.x) - lse1) * LOG2E);
        sc[4 * j + 3] = hopper::exp2_approx((fmaf(sc[4 * j + 3], scale, kb.y) - lse1) * LOG2E);
      }
      if (CAUSAL && it * C::STREAM + C::STREAM > q0) {
        // a key after the query: p = 0
        const int k = it * C::STREAM + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (k + 8 * j > qr0) sc[4 * j + 0] = 0.0f;
          if (k + 8 * j + 1 > qr0) sc[4 * j + 1] = 0.0f;
          if (k + 8 * j > qr1) sc[4 * j + 2] = 0.0f;
          if (k + 8 * j + 1 > qr1) sc[4 * j + 3] = 0.0f;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dp[4 * j + 0] = sc[4 * j + 0] * (dp[4 * j + 0] - delta0) * scale;
        dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - delta0) * scale;
        dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - delta1) * scale;
        dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - delta1) * scale;
      }
      uint32_t dsa[4][4];  // dS as bf16 A fragments
      acc_to_a<64>(dsa, dp);

      hopper::wgmma_fence();
      grad_product<C, DQK>(acc_dq, dsa, sK);  // dQ += dS . K
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_dq);
      hopper::fence_regs(dsa);
      hopper::mbar_arrive(sm.empty(s));
    }

    store_acc<DQK>(acc_dq, qr0, S, dq, sdq, b, h);
  }
}

// ----------------------------------------------------------------- kernels

// ALBERT's kernels: one width, the per-key bias alone (their names are what
// the traces and the benchmark's flash_roofline read)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ lse, Strides so, int S, int H,
                     float scale) {
  fwd_body<D, D, false>(tm_q, tm_k, tm_v, bias, out, lse, so, S, H, scale);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ bias, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, Strides sdk, Strides sdv, int S, int H,
                          float scale) {
  bwd_dkdv_body<D, D, false>(tm_q, tm_k, tm_v, tm_do, bias, lse, delta, dk, dv, sdk, sdv, S, H,
                             scale);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ bias, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq, Strides sdq,
                        int S, int H, float scale) {
  bwd_dq_body<D, D, false>(tm_q, tm_k, tm_v, tm_do, bias, lse, delta, dq, sdq, S, H, scale);
}

// Latent attention's kernels: q/k DQK wide, v/out DV wide, causal or not
template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
    flash_mla_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ bias, bf16* __restrict__ out,
                         float* __restrict__ lse, Strides so, int S, int H, float scale) {
  fwd_body<DQK, DV, CAUSAL>(tm_q, tm_k, tm_v, bias, out, lse, so, S, H, scale);
}

template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
    flash_mla_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ bias, const float* __restrict__ lse,
                              const float* __restrict__ delta, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, Strides sdk, Strides sdv, int S, int H,
                              float scale) {
  bwd_dkdv_body<DQK, DV, CAUSAL>(tm_q, tm_k, tm_v, tm_do, bias, lse, delta, dk, dv, sdk, sdv, S,
                                 H, scale);
}

template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
    flash_mla_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ bias, const float* __restrict__ lse,
                            const float* __restrict__ delta, bf16* __restrict__ dq, Strides sdq,
                            int S, int H, float scale) {
  bwd_dq_body<DQK, DV, CAUSAL>(tm_q, tm_k, tm_v, tm_do, bias, lse, delta, dq, sdq, S, H, scale);
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
cudaError_t set_smem_limit(Kernel kernel, int smem_bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

// a bf16 [B, S, H, D] tensor map with 64-row boxes in the swizzle of D's
// column chunks
template <int D>
bool encode_map(CUtensorMap* map, const bf16* t, Strides st, int B, int S, int H) {
  return hopper::encode_bshd<chunk_width<D>(), 64>(map, t, B, S, H, D, st.b, st.s, st.h);
}

// A forward launch of ``kernel`` (q/k DQK wide, v/out DV wide); each kernel
// is its own instantiation, so each raises its own shared-memory limit
template <int DQK, int DV, auto kernel>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v,
                       const float* bias, bf16* out, float* lse, Strides sq, Strides sk,
                       Strides sv, Strides so, int B, int S, int H, float scale,
                       cudaStream_t stream) {
  using C = Fwd<DQK, DV>;
  // raised once per instantiation (not per launch, so launches can be
  // captured into a CUDA graph)
  static const cudaError_t limit = set_smem_limit(kernel, C::SMEM);
  if (limit != cudaSuccess) return limit;
  // the maps go by value as kernel parameters, so a captured graph keeps them
  CUtensorMap maps[3];
  if (!(encode_map<DQK>(&maps[0], q, sq, B, S, H) && encode_map<DQK>(&maps[1], k, sk, B, S, H) &&
        encode_map<DV>(&maps[2], v, sv, B, S, H)))
    return cudaErrorInvalidValue;
  dim3 grid(B * H, (S + C::RES - 1) / C::RES);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], bias, out, lse, so, S, H,
                                             scale);
  return cudaGetLastError();
}

// the four bf16 [B, S, H, D] tensor maps of a backward launch
template <int DQK, int DV>
bool encode_bwd_maps(CUtensorMap (&maps)[4], const bf16* q, const bf16* k, const bf16* v,
                     const bf16* dout, Strides sq, Strides sk, Strides sv, Strides sdo, int B,
                     int S, int H) {
  return encode_map<DQK>(&maps[0], q, sq, B, S, H) && encode_map<DQK>(&maps[1], k, sk, B, S, H) &&
         encode_map<DV>(&maps[2], v, sv, B, S, H) && encode_map<DV>(&maps[3], dout, sdo, B, S, H);
}

template <int DQK, int DV, auto kernel>
cudaError_t launch_bwd_dkdv(const bf16* q, const bf16* k, const bf16* v,
                            const float* bias, const float* lse, const float* delta,
                            const bf16* dout, bf16* dk, bf16* dv, Strides sq, Strides sk,
                            Strides sv, Strides sdo, Strides sdk, Strides sdv, int B, int S,
                            int H, float scale, cudaStream_t stream) {
  constexpr int smem = Bwd<DQK, DV>::SMEM;
  static const cudaError_t limit = set_smem_limit(kernel, smem);
  if (limit != cudaSuccess) return limit;
  CUtensorMap maps[4];
  if (!encode_bwd_maps<DQK, DV>(maps, q, k, v, dout, sq, sk, sv, sdo, B, S, H))
    return cudaErrorInvalidValue;
  dim3 grid(B * H, (S + Bwd<DQK, DV>::RES - 1) / Bwd<DQK, DV>::RES);
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], bias, lse, delta,
                                          dk, dv, sdk, sdv, S, H, scale);
  return cudaGetLastError();
}

template <int DQK, int DV, auto kernel>
cudaError_t launch_bwd_dq(const bf16* q, const bf16* k, const bf16* v,
                          const float* bias, const float* lse, const float* delta,
                          const bf16* dout, bf16* dq, Strides sq, Strides sk, Strides sv,
                          Strides sdo, Strides sdq, int B, int S, int H, float scale,
                          cudaStream_t stream) {
  constexpr int smem = Bwd<DQK, DV>::SMEM;
  static const cudaError_t limit = set_smem_limit(kernel, smem);
  if (limit != cudaSuccess) return limit;
  CUtensorMap maps[4];
  if (!encode_bwd_maps<DQK, DV>(maps, q, k, v, dout, sq, sk, sv, sdo, B, S, H))
    return cudaErrorInvalidValue;
  dim3 grid(B * H, (S + Bwd<DQK, DV>::RES - 1) / Bwd<DQK, DV>::RES);
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], bias, lse, delta,
                                          dq, sdq, S, H, scale);
  return cudaGetLastError();
}

Strides strides_of(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

#define DISPATCH_HEAD_DIM(D, CALL)          \
  switch (D) {                              \
    case 16: { constexpr int kD = 16; return CALL; }   \
    case 32: { constexpr int kD = 32; return CALL; }   \
    case 48: { constexpr int kD = 48; return CALL; }   \
    case 64: { constexpr int kD = 64; return CALL; }   \
    case 80: { constexpr int kD = 80; return CALL; }   \
    case 96: { constexpr int kD = 96; return CALL; }   \
    case 112: { constexpr int kD = 112; return CALL; } \
    case 128: { constexpr int kD = 128; return CALL; } \
    default: return (int)cudaErrorInvalidValue;        \
  }

// the latent-attention widths (q/k, v) and the causal flag instantiated
#define DISPATCH_MLA(DQK, DV, CAUSAL, CALL)                                          \
  if ((DQK) == 192 && (DV) == 128) {                                                 \
    constexpr int kDqk = 192, kDv = 128;                                             \
    if (CAUSAL) {                                                                    \
      constexpr bool kCausal = true;                                                 \
      return CALL;                                                                   \
    } else {                                                                         \
      constexpr bool kCausal = false;                                                \
      return CALL;                                                                   \
    }                                                                                \
  }                                                                                  \
  return (int)cudaErrorInvalidValue;

// Plain C interface (loaded with ctypes). Each *_strides argument points at
// three int64 element strides (batch, sequence, head) of a [B, S, H, D]
// tensor. Every entry point returns cudaGetLastError() after its launch.
extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
              void* lse, const long long* q_strides, const long long* k_strides,
              const long long* v_strides, const long long* out_strides, int B, int S, int H,
              int D, float scale, void* stream) {
  DISPATCH_HEAD_DIM(D, (int)(launch_fwd<kD, kD, flash_fwd_kernel<kD>>(
                           (const bf16*)q, (const bf16*)k,
                           (const bf16*)v, (const float*)bias, (bf16*)out, (float*)lse,
                           strides_of(q_strides), strides_of(k_strides), strides_of(v_strides),
                           strides_of(out_strides), B, S, H, scale, (cudaStream_t)stream)))
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* bias,
                   const void* lse, const void* delta, const void* dout, void* dk, void* dv,
                   const long long* q_strides, const long long* k_strides,
                   const long long* v_strides, const long long* dout_strides,
                   const long long* dk_strides, const long long* dv_strides, int B, int S,
                   int H, int D, float scale, void* stream) {
  DISPATCH_HEAD_DIM(D, (int)(launch_bwd_dkdv<kD, kD, flash_bwd_dkdv_kernel<kD>>(
                           (const bf16*)q, (const bf16*)k,
                           (const bf16*)v, (const float*)bias, (const float*)lse,
                           (const float*)delta, (const bf16*)dout, (bf16*)dk, (bf16*)dv,
                           strides_of(q_strides), strides_of(k_strides), strides_of(v_strides),
                           strides_of(dout_strides), strides_of(dk_strides),
                           strides_of(dv_strides), B, S, H, scale, (cudaStream_t)stream)))
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                 const void* lse, const void* delta, const void* dout, void* dq,
                 const long long* q_strides, const long long* k_strides,
                 const long long* v_strides, const long long* dout_strides,
                 const long long* dq_strides, int B, int S, int H, int D, float scale,
                 void* stream) {
  DISPATCH_HEAD_DIM(D, (int)(launch_bwd_dq<kD, kD, flash_bwd_dq_kernel<kD>>(
                           (const bf16*)q, (const bf16*)k,
                           (const bf16*)v, (const float*)bias, (const float*)lse,
                           (const float*)delta, (const bf16*)dout, (bf16*)dq,
                           strides_of(q_strides), strides_of(k_strides), strides_of(v_strides),
                           strides_of(dout_strides), strides_of(dq_strides), B, S, H, scale,
                           (cudaStream_t)stream)))
}

int flash_mla_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                  void* lse, const long long* q_strides, const long long* k_strides,
                  const long long* v_strides, const long long* out_strides, int B, int S, int H,
                  int Dqk, int Dv, int causal, float scale, void* stream) {
  DISPATCH_MLA(Dqk, Dv, causal,
               (int)(launch_fwd<kDqk, kDv, flash_mla_fwd_kernel<kDqk, kDv, kCausal>>(
                   (const bf16*)q, (const bf16*)k,
                   (const bf16*)v, (const float*)bias, (bf16*)out, (float*)lse,
                   strides_of(q_strides), strides_of(k_strides), strides_of(v_strides),
                   strides_of(out_strides), B, S, H, scale, (cudaStream_t)stream)))
}

int flash_mla_bwd_dkdv(const void* q, const void* k, const void* v, const void* bias,
                       const void* lse, const void* delta, const void* dout, void* dk, void* dv,
                       const long long* q_strides, const long long* k_strides,
                       const long long* v_strides, const long long* dout_strides,
                       const long long* dk_strides, const long long* dv_strides, int B, int S,
                       int H, int Dqk, int Dv, int causal, float scale, void* stream) {
  DISPATCH_MLA(Dqk, Dv, causal,
               (int)(launch_bwd_dkdv<kDqk, kDv, flash_mla_bwd_dkdv_kernel<kDqk, kDv, kCausal>>(
                   (const bf16*)q,
                   (const bf16*)k, (const bf16*)v, (const float*)bias, (const float*)lse,
                   (const float*)delta, (const bf16*)dout, (bf16*)dk, (bf16*)dv,
                   strides_of(q_strides), strides_of(k_strides), strides_of(v_strides),
                   strides_of(dout_strides), strides_of(dk_strides), strides_of(dv_strides), B,
                   S, H, scale, (cudaStream_t)stream)))
}

int flash_mla_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                     const void* lse, const void* delta, const void* dout, void* dq,
                     const long long* q_strides, const long long* k_strides,
                     const long long* v_strides, const long long* dout_strides,
                     const long long* dq_strides, int B, int S, int H, int Dqk, int Dv,
                     int causal, float scale, void* stream) {
  DISPATCH_MLA(Dqk, Dv, causal,
               (int)(launch_bwd_dq<kDqk, kDv, flash_mla_bwd_dq_kernel<kDqk, kDv, kCausal>>(
                   (const bf16*)q,
                   (const bf16*)k, (const bf16*)v, (const float*)bias, (const float*)lse,
                   (const float*)delta, (const bf16*)dout, (bf16*)dq, strides_of(q_strides),
                   strides_of(k_strides), strides_of(v_strides), strides_of(dout_strides),
                   strides_of(dq_strides), B, S, H, scale, (cudaStream_t)stream)))
}

}  // extern "C"
