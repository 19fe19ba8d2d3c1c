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
// Forward. At the ALBERT-large slice (B=12, S=512, H=16, D=64) it moves
// ~50 MB and does ~13 GFLOP, so bytes and tensor-core operations are nearly
// balanced (~15 us each). The TPU grid ran the KV axis sequentially and
// carried (acc, m, l) in VMEM scratch; here one block owns one (batch*head,
// 64-query tile) and loops over 64-key tiles itself, each of its 4 warps
// owning 16 query rows on mma.sync m16n8k16 with ldmatrix operands, scores
// and accumulators in registers.
//
// Backward. The fused TPU backward kept one 512x512 fp32 score tile per head
// in VMEM (1 MB), which does not fit in 227 KB of shared memory, so the
// backward is two kernels that recompute p = exp(s - lse): dK/dV with one
// block per 128-key tile looping over 64-query tiles, and dQ with one block
// per 128-query tile looping over 64-key tiles. Each output tile has one
// owner: no atomics, and repeated runs are bitwise equal.
// - What bounds them: operations. Per score, dK/dV does 4 products (S^T =
//   K.Q^T, dP^T = V.dO^T, dV += P^T.dO, dK += dS^T.Q) and dQ 3 (S = Q.K^T,
//   dP = dO.V^T, dQ += dS.K), 2 D flops each on the bf16 tensor cores, plus
//   one exp per score on the special-function units; HBM traffic is O(S*D)
//   per head. At [2, 16384, 16, 64] that is 4.45 and 3.34 ms of tensor-core
//   time at 989 TFLOP/s, against ~0.02 ms of bytes.
// - What the design does about it: every product is a warpgroup wgmma
//   (m64nNk16, bf16 x bf16 -> fp32), the only instruction that reaches the
//   tensor cores' full rate. A block is three warpgroups: one producer warp
//   and two consumer warpgroups of 64 resident rows each (setmaxnreg moves
//   registers from the producer to the consumers). The resident tile (K and V
//   for dK/dV, Q and dO for dQ; 128 rows) is loaded once by TMA and stays in
//   shared memory; the streamed tiles (Q, dO, lse, delta for dK/dV; K, V and
//   the bias row for dQ) arrive through a ring of STAGES buffers filled by
//   TMA (cp.async.bulk.tensor, 4-D tensor maps over (D, H, S, B) built from
//   the strides, zero fill past S) and handed over with mbarriers, so the
//   copy of the next tiles overlaps the products on the current one. The
//   score products read both operands from shared memory (K-major); the
//   gradient products take P^T / dS^T (or dS) from registers, converted in
//   place from the fp32 accumulator, and B from the same streamed tile with
//   the transpose bit (MN-major). Shared tiles use wgmma's swizzled layouts
//   (128-byte swizzle at D=64; hopper.cuh). Exps are ex2.approx on
//   (s * scale + bias - lse) * log2(e), the difference taken first in fp32 as
//   the reference does.
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

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // key rows per tile
constexpr int NWARPS = 4;         // each warp owns 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD_H = 8;          // bf16 row padding: 16-byte rows, conflict-free ldmatrix
constexpr float NEG_INF = -1e30f; // the TPU kernel's initial running max

// element strides of a [B, S, H, D] tensor whose last dimension is contiguous
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float neg_infinity() { return __int_as_float(0xff800000); }

// ---- tensor-core fragments (mma.sync m16n8k16, bf16 in, fp32 accumulate).
// With g = lane / 4 and t = lane % 4, a thread holds
//   A 16x16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8:  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//   C 16x8:  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment of rows [row0, +16), cols [col0, +16) of a row-major tile (ld LDH)
template <int LDH>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile, int row0, int col0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(r, tile + (row0 + lane % 16) * LDH + col0 + (lane / 16) * 8);
}

// B fragments of two 8-wide n tiles where B[k][n] = M[n0 + n][k0 + k]
// (M row-major: n rows, k contiguous): r0, r1 for n tile 0; r2, r3 for tile 1
template <int LDH>
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const bf16* tile, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(r, tile + (n0 + lane % 8 + (lane / 16) * 8) * LDH + k0 + ((lane / 8) % 2) * 8);
}

// B fragments of two 8-wide n tiles where B[k][n] = M[k0 + k][n0 + n]
// (M row-major: k rows, n contiguous), through the transposing load
template <int LDH>
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(r, tile + (k0 + lane % 16) * LDH + n0 + (lane / 16) * 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of 16 columns [16 kk, +16) of a 16 x 64 C-layout strip
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[8][4], int kk) {
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

// rows [row0, row0+64) of head (b, h) into a padded shared tile; rows >= S are zero
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, Strides st, int b,
                                          int h, int row0, int S) {
  constexpr int VEC = 8;  // bf16 per 16-byte vector
  constexpr int VPR = D / VEC;
  constexpr int LDH = D + PAD_H;
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) {
      val = *reinterpret_cast<const uint4*>(src + b * st.b + (long long)row * st.s +
                                            h * st.h + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// acc[D/8][4] += P (16 x 64, C layout) . M (64 rows x D, row-major tile)
template <int D>
__device__ __forceinline__ void strip_pm(float (&acc)[D / 8][4], const float (&p)[8][4],
                                         const bf16* m) {
  constexpr int LDH = D + PAD_H;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t fa[4];
    c_to_a(fa, p, kk);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t fb[4];
      load_b_kn<LDH>(fb, m, kk * 16, dp * 16);
      mma16816(acc[2 * dp], fa, fb[0], fb[1]);
      mma16816(acc[2 * dp + 1], fa, fb[2], fb[3]);
    }
  }
}

template <int D>
constexpr int fwd_smem_bytes() {
  return 3 * 64 * (D + PAD_H) * 2 + 64 * 4;
}

// ---------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int S, int H, float scale) {
  constexpr int LDH = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + 64 * LDH;
  bf16* sV = sK + 64 * LDH;
  float* sBias = reinterpret_cast<float*>(sV + 64 * LDH);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // this warp's query rows within the tile

  load_tile<D>(sQ, q, sq, b, h, q0, S);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<LDH>(qf[kk], sQ, r0, kk * 16);

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;  // rows g and g+8

  const int n_tiles = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, k, sk, b, h, k0, S);
    load_tile<D>(sV, v, sv, b, h, k0, S);
    for (int i = threadIdx.x; i < BK; i += NTHREADS)
      sBias[i] = (k0 + i < S) ? bias[(long long)b * S + k0 + i] : 0.0f;
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t fb[4];
        load_b_nk<LDH>(fb, sK, np * 16, kk * 16);
        mma16816(s[2 * np], qf[kk], fb[0], fb[1]);
        mma16816(s[2 * np + 1], qf[kk], fb[2], fb[3]);
      }
    }

    // online softmax over this key tile; keys past S get probability 0
    float mx0 = neg_infinity(), mx1 = neg_infinity();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const bool ok = k0 + col < S;
        const float kb = sBias[col];
        s[j][e] = ok ? s[j][e] * scale + kb : neg_infinity();
        s[j][2 + e] = ok ? s[j][2 + e] * scale + kb : neg_infinity();
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(s[j][e] - mn0);
        s[j][2 + e] = expf(s[j][2 + e] - mn1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
    l0 = l0 * corr0 + quad_sum(sum0);
    l1 = l1 * corr1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr0;
      o[j][1] *= corr0;
      o[j][2] *= corr1;
      o[j][3] *= corr1;
    }
    strip_pm<D>(o, s, sV);  // P rounded to bf16 before P.V
  }

  // out = acc / max(l, 1e-30) (a division, as the TPU kernel), lse = m + log(max(l, 1e-30))
  const float sl0 = fmaxf(l0, 1e-30f), sl1 = fmaxf(l1, 1e-30f);
  const int row_g = q0 + r0 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_g + 8 * half;
    if (row >= S) continue;
    const float sl = half ? sl1 : sl0;
    bf16* dst = out + b * so.b + (long long)row * so.s + h * so.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8 + 2 * t) =
          pack_bf16(o[j][2 * half] / sl, o[j][2 * half + 1] / sl);
    if (t == 0) lse[(long long)bh * S + row] = (half ? m1 : m0) + logf(sl);
  }
}

// ---------------------------------------------------------------- backward

constexpr int BWD_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 = 384 x 168 registers
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float pos_infinity() { return __int_as_float(0x7f800000); }

// Shared memory of a backward block, from a 1024-byte aligned base: two
// resident tiles of RES rows, STAGES ring slots of two streamed tiles of
// STREAM rows and two fp32 rows of STREAM, then the mbarriers.
template <int D>
struct Bwd {
  static constexpr int CW = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;  // swizzle row, bf16
  static constexpr int RES = 128;   // resident rows: one 64-row slab per consumer warpgroup
  static constexpr int STREAM = 64;  // rows per streamed tile
  static constexpr int STAGES = 3;
  static constexpr int RES_BYTES = RES * D * 2;
  static constexpr int TILE_BYTES = STREAM * D * 2;
  static constexpr int SLOT_BYTES = 2 * TILE_BYTES;
  static constexpr int OFF_STREAM = 2 * RES_BYTES;
  static constexpr int OFF_ROWS = OFF_STREAM + STAGES * SLOT_BYTES;
  static constexpr int OFF_BARS = OFF_ROWS + STAGES * 2 * STREAM * 4;
  static constexpr int SMEM = OFF_BARS + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
  static_assert(RES_BYTES % 1024 == 0 && TILE_BYTES % 1024 == 0, "swizzle alignment");
};

// The block's shared memory and barriers: full[s] (the producer warp's 32
// arrivals plus the TMA bytes of slot s), empty[s] (every consumer thread
// done with slot s), res (the resident tiles' TMA bytes).
template <int D>
struct BwdSmem {
  using C = Bwd<D>;
  uint32_t base;
  float* rows;
  __device__ explicit BwdSmem(unsigned char* raw_ptr) {
    const uint32_t raw = hopper::smem_addr(raw_ptr);
    base = (raw + 1023u) & ~1023u;
    rows = reinterpret_cast<float*>(raw_ptr + (base - raw) + C::OFF_ROWS);
  }
  __device__ uint32_t res(int i) const { return base + i * C::RES_BYTES; }
  __device__ uint32_t tile(int slot, int i) const {
    return base + C::OFF_STREAM + slot * C::SLOT_BYTES + i * C::TILE_BYTES;
  }
  __device__ float* row(int slot, int i) const { return rows + (2 * slot + i) * C::STREAM; }
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

// rows [row0, row0 + 128) of head (b, h) of two tensors into the resident
// tiles, as 64-row boxes per column chunk (one thread)
template <int D>
__device__ __forceinline__ void load_resident(const BwdSmem<D>& sm, const CUtensorMap* m0,
                                              const CUtensorMap* m1, int b, int h, int row0) {
  using C = Bwd<D>;
  hopper::mbar_expect_tx(sm.res_bar(), 2 * C::RES_BYTES);
#pragma unroll
  for (int c = 0; c < D / C::CW; ++c)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t off = c * C::RES * C::CW * 2 + half * 64 * C::CW * 2;
      hopper::tma_load_4d(sm.res(0) + off, m0, sm.res_bar(), c * C::CW, h, row0 + 64 * half, b);
      hopper::tma_load_4d(sm.res(1) + off, m1, sm.res_bar(), c * C::CW, h, row0 + 64 * half, b);
    }
  hopper::mbar_arrive(sm.res_bar());
}

// rows [row0, row0 + 64) of head (b, h) of two tensors into ring slot s (one
// thread; the slot's full barrier counts the bytes)
template <int D>
__device__ __forceinline__ void load_stream(const BwdSmem<D>& sm, int s, const CUtensorMap* m0,
                                            const CUtensorMap* m1, int b, int h, int row0) {
  using C = Bwd<D>;
  hopper::mbar_expect_tx(sm.full(s), C::SLOT_BYTES);
#pragma unroll
  for (int c = 0; c < D / C::CW; ++c) {
    const uint32_t off = c * C::STREAM * C::CW * 2;
    hopper::tma_load_4d(sm.tile(s, 0) + off, m0, sm.full(s), c * C::CW, h, row0, b);
    hopper::tma_load_4d(sm.tile(s, 1) + off, m1, sm.full(s), c * C::CW, h, row0, b);
  }
}

// S (or S^T, dP, dP^T) = rows [64 w, +64) of a resident tile . (a streamed
// tile)^T over D: one wgmma per 16 columns, both operands K-major
template <int D>
__device__ __forceinline__ void score_product(float (&acc)[32], uint32_t res, int w,
                                              uint32_t tile) {
  using C = Bwd<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss_n64<0>(acc, hopper::desc_kmajor<C::CW, C::RES>(res, 64 * w, kk),
                            hopper::desc_kmajor<C::CW, C::STREAM>(tile, 0, kk), kk > 0);
}

// acc[64 x D] += A[64 x 64] (registers) . (a streamed tile, 64 x D)
template <int D>
__device__ __forceinline__ void grad_product(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                             uint32_t tile) {
  using C = Bwd<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::wgmma_rs_t_wide<D, C::CW, C::STREAM>(acc, a[kk], tile, kk);
}

// the A fragments (K = 64 in 4 steps of 16) of a 64 x 64 wgmma accumulator,
// rounded to bf16: per warp the accumulator has mma.sync's C layout and
// wgmma's register A has mma.sync's A layout
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&c)[32]) {
  const auto& strip = reinterpret_cast<const float(&)[8][4]>(c);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) c_to_a(a[kk], strip, kk);
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
__device__ __forceinline__ void block_tile(int& bh, int& tile) {
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  tile = lin % gridDim.y;
  bh = lin / gridDim.y;
}

// ----------------------------------------------------------- backward dK/dV

template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ bias, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, Strides sdk, Strides sdv, int S, int H,
                          float scale) {
  using C = Bwd<D>;
  extern __shared__ unsigned char smem[];
  const BwdSmem<D> sm(smem);
  int bh, kt;
  block_tile(bh, kt);
  const int b = bh / H, h = bh % H;
  const int k0 = kt * C::RES;
  const int n_tiles = (S + C::STREAM - 1) / C::STREAM;
  sm.init_barriers();

  if (threadIdx.x < 128) {
    // producer: warp 0 keeps the ring full; the other warps leave
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) load_resident<D>(sm, &tm_k, &tm_v, b, h, k0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::STAGES;
      const int q0 = it * C::STREAM;
      hopper::mbar_wait(sm.empty(s), ((it / C::STAGES) & 1) ^ 1);
      if (lane == 0) load_stream<D>(sm, s, &tm_q, &tm_do, b, h, q0);
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

    float acc_dv[D / 2], acc_dk[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dv[i] = acc_dk[i] = 0.0f;

    hopper::mbar_wait(sm.res_bar(), 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::STAGES;
      hopper::mbar_wait(sm.full(s), (it / C::STAGES) & 1);
      const uint32_t sQ = sm.tile(s, 0), sDO = sm.tile(s, 1);
      const float* r_lse = sm.row(s, 0);
      const float* r_delta = sm.row(s, 1);

      float st[32], dpt[32];  // S^T and dP^T: 64 keys x 64 queries
      hopper::wgmma_fence();
      score_product<D>(st, sm.res(0), w, sQ);  // S^T = K . Q^T
      hopper::wgmma_commit();
      score_product<D>(dpt, sm.res(1), w, sDO);  // dP^T = V . dO^T
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
      acc_to_a(pa, st);
      acc_to_a(dsa, dpt);

      hopper::wgmma_fence();
      grad_product<D>(acc_dv, pa, sDO);  // dV += P^T . dO
      grad_product<D>(acc_dk, dsa, sQ);  // dK += dS^T . Q
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_dv);
      hopper::fence_regs(acc_dk);
      hopper::fence_regs(pa);
      hopper::fence_regs(dsa);
      hopper::mbar_arrive(sm.empty(s));
    }

    store_acc<D>(acc_dv, key0, S, dv, sdv, b, h);
    store_acc<D>(acc_dk, key0, S, dk, sdk, b, h);
  }
}

// -------------------------------------------------------------- backward dQ

template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ bias, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq, Strides sdq,
                        int S, int H, float scale) {
  using C = Bwd<D>;
  extern __shared__ unsigned char smem[];
  const BwdSmem<D> sm(smem);
  int bh, qt;
  block_tile(bh, qt);
  const int b = bh / H, h = bh % H;
  const int q0 = qt * C::RES;
  const int n_tiles = (S + C::STREAM - 1) / C::STREAM;
  sm.init_barriers();

  if (threadIdx.x < 128) {
    // producer: warp 0 keeps the ring full; the other warps leave
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) load_resident<D>(sm, &tm_q, &tm_do, b, h, q0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::STAGES;
      const int k0 = it * C::STREAM;
      hopper::mbar_wait(sm.empty(s), ((it / C::STAGES) & 1) ^ 1);
      if (lane == 0) load_stream<D>(sm, s, &tm_k, &tm_v, b, h, k0);
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

    float acc_dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.0f;

    hopper::mbar_wait(sm.res_bar(), 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::STAGES;
      hopper::mbar_wait(sm.full(s), (it / C::STAGES) & 1);
      const uint32_t sK = sm.tile(s, 0), sV = sm.tile(s, 1);
      const float* r_bias = sm.row(s, 0);

      float sc[32], dp[32];  // S and dP: 64 queries x 64 keys
      hopper::wgmma_fence();
      score_product<D>(sc, sm.res(0), w, sK);  // S = Q . K^T
      hopper::wgmma_commit();
      score_product<D>(dp, sm.res(1), w, sV);  // dP = dO . V^T
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
      acc_to_a(dsa, dp);

      hopper::wgmma_fence();
      grad_product<D>(acc_dq, dsa, sK);  // dQ += dS . K
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_dq);
      hopper::fence_regs(dsa);
      hopper::mbar_arrive(sm.empty(s));
    }

    store_acc<D>(acc_dq, qr0, S, dq, sdq, b, h);
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
cudaError_t set_smem_limit(Kernel kernel, int smem_bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

template <int D>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                       bf16* out, float* lse, Strides sq, Strides sk, Strides sv, Strides so,
                       int B, int S, int H, float scale, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  // raised once per instantiation (not per launch, so launches can be
  // captured into a CUDA graph)
  static const cudaError_t limit = set_smem_limit(flash_fwd_kernel<D>, smem);
  if (limit != cudaSuccess) return limit;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(q, k, v, bias, out, lse, sq, sk, sv,
                                                        so, S, H, scale);
  return cudaGetLastError();
}

// the four bf16 [B, S, H, D] tensor maps of a backward launch (64-row boxes)
template <int D>
bool encode_bwd_maps(CUtensorMap (&maps)[4], const bf16* q, const bf16* k, const bf16* v,
                     const bf16* dout, Strides sq, Strides sk, Strides sv, Strides sdo, int B,
                     int S, int H) {
  constexpr int CW = Bwd<D>::CW, ROWS = Bwd<D>::STREAM;
  return hopper::encode_bshd<CW, ROWS>(&maps[0], q, B, S, H, D, sq.b, sq.s, sq.h) &&
         hopper::encode_bshd<CW, ROWS>(&maps[1], k, B, S, H, D, sk.b, sk.s, sk.h) &&
         hopper::encode_bshd<CW, ROWS>(&maps[2], v, B, S, H, D, sv.b, sv.s, sv.h) &&
         hopper::encode_bshd<CW, ROWS>(&maps[3], dout, B, S, H, D, sdo.b, sdo.s, sdo.h);
}

template <int D>
cudaError_t launch_bwd_dkdv(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                            const float* lse, const float* delta, const bf16* dout, bf16* dk,
                            bf16* dv, Strides sq, Strides sk, Strides sv, Strides sdo,
                            Strides sdk, Strides sdv, int B, int S, int H, float scale,
                            cudaStream_t stream) {
  constexpr int smem = Bwd<D>::SMEM;
  // raised once per instantiation (not per launch, so launches can be
  // captured into a CUDA graph)
  static const cudaError_t limit = set_smem_limit(flash_bwd_dkdv_kernel<D>, smem);
  if (limit != cudaSuccess) return limit;
  // the maps go by value as kernel parameters, so a captured graph keeps them
  CUtensorMap maps[4];
  if (!encode_bwd_maps<D>(maps, q, k, v, dout, sq, sk, sv, sdo, B, S, H))
    return cudaErrorInvalidValue;
  dim3 grid(B * H, (S + Bwd<D>::RES - 1) / Bwd<D>::RES);
  flash_bwd_dkdv_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bias, lse, delta, dk, dv, sdk, sdv, S, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dq(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                          const float* lse, const float* delta, const bf16* dout, bf16* dq,
                          Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, int B,
                          int S, int H, float scale, cudaStream_t stream) {
  constexpr int smem = Bwd<D>::SMEM;
  static const cudaError_t limit = set_smem_limit(flash_bwd_dq_kernel<D>, smem);
  if (limit != cudaSuccess) return limit;
  CUtensorMap maps[4];
  if (!encode_bwd_maps<D>(maps, q, k, v, dout, sq, sk, sv, sdo, B, S, H))
    return cudaErrorInvalidValue;
  dim3 grid(B * H, (S + Bwd<D>::RES - 1) / Bwd<D>::RES);
  flash_bwd_dq_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bias, lse, delta, dq, sdq, S, H, scale);
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

// Plain C interface (loaded with ctypes). Each *_strides argument points at
// three int64 element strides (batch, sequence, head) of a [B, S, H, D]
// tensor. Every entry point returns cudaGetLastError() after its launch.
extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
              void* lse, const long long* q_strides, const long long* k_strides,
              const long long* v_strides, const long long* out_strides, int B, int S, int H,
              int D, float scale, void* stream) {
  DISPATCH_HEAD_DIM(D, (int)launch_fwd<kD>(
                           (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
                           (bf16*)out, (float*)lse, strides_of(q_strides),
                           strides_of(k_strides), strides_of(v_strides),
                           strides_of(out_strides), B, S, H, scale, (cudaStream_t)stream))
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* bias,
                   const void* lse, const void* delta, const void* dout, void* dk, void* dv,
                   const long long* q_strides, const long long* k_strides,
                   const long long* v_strides, const long long* dout_strides,
                   const long long* dk_strides, const long long* dv_strides, int B, int S,
                   int H, int D, float scale, void* stream) {
  DISPATCH_HEAD_DIM(D, (int)launch_bwd_dkdv<kD>(
                           (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
                           (const float*)lse, (const float*)delta, (const bf16*)dout,
                           (bf16*)dk, (bf16*)dv, strides_of(q_strides), strides_of(k_strides),
                           strides_of(v_strides), strides_of(dout_strides),
                           strides_of(dk_strides), strides_of(dv_strides), B, S, H, scale,
                           (cudaStream_t)stream))
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                 const void* lse, const void* delta, const void* dout, void* dq,
                 const long long* q_strides, const long long* k_strides,
                 const long long* v_strides, const long long* dout_strides,
                 const long long* dq_strides, int B, int S, int H, int D, float scale,
                 void* stream) {
  DISPATCH_HEAD_DIM(D, (int)launch_bwd_dq<kD>(
                           (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
                           (const float*)lse, (const float*)delta, (const bf16*)dout,
                           (bf16*)dq, strides_of(q_strides), strides_of(k_strides),
                           strides_of(v_strides), strides_of(dout_strides),
                           strides_of(dq_strides), B, S, H, scale, (cudaStream_t)stream))
}

}  // extern "C"
