// The chunked gated delta rule of Kimi Delta Attention (KDA; Kimi Linear,
// arXiv 2510.26692) for Hopper (sm_90a): two forward and two backward
// kernels over chunks of C = 16 tokens, heads d_k = d_v = 128 wide.
//
// Replaces no TPU kernel: the JAX package has no linear-attention layer. The
// mathematics, the chunked (WY) form and the backward's derivation are in
// ops/kda.py, whose plain mirror (kda_fwd_plain, kda_bwd_plain) computes
// what these kernels compute, in the same order, one function per kernel.
//
// Layout: q, k, v, W, O, dO, dq, dk, dv are [B, S, H, 128] bf16; g, dg, Ũ/U,
// dU are [B, S, H, 128] fp32; β and dβ [B, S, H] fp32; M is [B*H, N, C, C]
// fp32 (N = ceil(S / C) chunks a sequence); each chunk's starting state S_0
// and its end state's gradient dS are [B*H, N, 128, 128] fp32. Rows past S
// read as q = k = v = g = β = 0 (the state passes them unchanged) and are
// not written.
//
// - kda_fwd_intra_kernel (grid N x B*H): a chunk's Â (β-free A), M, T =
//   (I + diag(β) Â)^-1 by forward substitution, W = T diag(β) (K ⊙ e^G)
//   (bf16) and Ũ = T diag(β) V (fp32).
// - kda_fwd_state_kernel (grid B*H x 128/BV): walks the chunks in order with
//   BV columns of the state in shared memory (fp32): stores each chunk's
//   S_0, U = Ũ - W S_0 (over Ũ) and O = scale ((Q ⊙ e^G) S_0 + M U), and at
//   the end the final state's sum of squares.
// - kda_bwd_state_kernel (grid B*H x 128/BV): walks the chunks in reverse
//   with BV columns of dS: stores dS per chunk and dU = scale Mᵀ dO + (K ⊙
//   e^{G_C - G}) dS.
// - kda_bwd_intra_kernel (grid N x B*H): a chunk's dq, dk, dv, dg and dβ
//   from S_0, dS, U, dU and dO.
//
// What bounds them on an H100, and what the design does about it. Every
// kernel moves O(B S H d) bytes: the states (64 KiB a chunk and head, in
// fp32, written by the state kernels and read back by the backward intra
// kernel) are most of them, and at [2, 8192, 32, 128, 128] the products
// need a fraction of the bytes' time on the tensor cores. The state kernels
// are sequential over the chunks: 4 column blocks a head give 256 blocks,
// about two an SM, so each chunk step's latency is their time. Their
// products with the state (W S, (Q ⊙ e^G) S, K_endᵀ U, M U and the backward's
// transposes) run on the tensor cores through WMMA (16 x 16 x 16, bf16
// operands, fp32 sums), the state and every sum staying in fp32; the next
// chunk's inputs are loaded into registers while the current chunk's
// products run, so a step waits on global memory once at most. The intra
// kernels' [C, C] algebra (the per-channel decay products, the triangular
// inverse and the products with T) runs on the CUDA cores in fp32: each decay
// term e^{G_t - G_s} is taken per channel from the difference, never as
// e^{G_t} e^{-G_s}, so a chunk whose decay sums far below -88 (fp32's exp
// overflows at +88) stays finite, and no chunk needs a second path. The
// backward intra kernel's products with the state (dO S_0ᵀ, dU S_0ᵀ, U dSᵀ)
// run on WMMA over 32-column slices of the state, staged through shared
// memory in bf16.
//
// No atomics: every output element has one owner, and every sum across
// threads is taken in a fixed order, so repeated runs are bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int C = 16;         // tokens a chunk
constexpr int D = 128;        // d_k = d_v
constexpr int BV = 32;        // state columns a block of the state kernels holds
constexpr int THREADS = 128;  // four warps; in the intra kernels one thread a channel
constexpr int WARPS = THREADS / 32;
constexpr int FP = D + 1;     // fp32 row stride of [C, D] tiles that (t, s) pairs read
constexpr int HP = D + 8;     // bf16 row stride of [C, D] WMMA operand tiles
constexpr int SP = BV + 8;    // bf16 row stride of [D, BV] and [C, BV] WMMA tiles
constexpr int AP = BV + 4;    // fp32 row stride of [D, BV] and [C, BV] WMMA tiles
constexpr int MP = C + 8;     // bf16 row stride of the [C, C] M tile
constexpr int RP = D + 4;     // fp32 row stride of [C, D] WMMA results

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ long long row_of(int b, int t, int h, int S, int H) {
  return ((long long)b * S + t) * H + h;
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ------------------------------------------------------------ intra chunk

// a chunk's q, k (fp32 of bf16) and cumulative decay G, and its β
struct Chunk {
  float q[C][FP], k[C][FP], g[C][FP];
  float beta[C];
};

// Thread c loads channel c of the chunk's rows (0 past S) and sums G down
// the chunk; threads 0..C-1 load β.
__device__ __forceinline__ void load_chunk(Chunk& ch, const bf16* __restrict__ q,
                                           const bf16* __restrict__ k,
                                           const float* __restrict__ g,
                                           const float* __restrict__ beta, int b, int n, int h,
                                           int S, int H) {
  const int c = threadIdx.x;
  float cum = 0.f;
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int tt = n * C + t;
    float qv = 0.f, kv = 0.f, gv = 0.f;
    if (tt < S) {
      const long long at = row_of(b, tt, h, S, H) * D + c;
      qv = __bfloat162float(q[at]);
      kv = __bfloat162float(k[at]);
      gv = g[at];
    }
    cum += gv;
    ch.q[t][c] = qv;
    ch.k[t][c] = kv;
    ch.g[t][c] = cum;
  }
  if (c < C) {
    const int tt = n * C + c;
    ch.beta[c] = tt < S ? beta[row_of(b, tt, h, S, H)] : 0.f;
  }
}

// Â_ts = Σ_c k_tc k_sc e^{G_tc - G_sc} (s < t, else 0) and, WITH_M, M_ts =
// Σ_c q_tc k_sc e^{G_tc - G_sc} (s <= t, else 0). Thread (t0, s), t0 =
// tid / 16 and s = tid % 16, takes the pairs (t0, s) and (t0 + 8, s); the
// fp32 tiles' odd row stride keeps the 16 rows s of a column in 16 banks.
template <bool WITH_M>
__device__ __forceinline__ void decay_products(const Chunk& ch, float (*a_hat)[C + 1],
                                               float (*m)[C + 1]) {
  const int s = threadIdx.x & (C - 1), t0 = threadIdx.x >> 4, t1 = t0 + 8;
  const bool on0 = s <= t0, on1 = s <= t1;
  float a0 = 0.f, a1 = 0.f, m0 = 0.f, m1 = 0.f;
  for (int c = 0; c < D; ++c) {
    const float gs = ch.g[s][c], ks = ch.k[s][c];
    if (on0) {
      const float e = ks * expf(ch.g[t0][c] - gs);
      a0 += ch.k[t0][c] * e;
      if constexpr (WITH_M) m0 += ch.q[t0][c] * e;
    }
    if (on1) {
      const float e = ks * expf(ch.g[t1][c] - gs);
      a1 += ch.k[t1][c] * e;
      if constexpr (WITH_M) m1 += ch.q[t1][c] * e;
    }
  }
  a_hat[t0][s] = s < t0 ? a0 : 0.f;
  a_hat[t1][s] = s < t1 ? a1 : 0.f;
  if constexpr (WITH_M) {
    m[t0][s] = on0 ? m0 : 0.f;
    m[t1][s] = on1 ? m1 : 0.f;
  }
}

// T = (I + diag(β) Â)^-1 of the strictly lower Â by forward substitution,
// a column j a thread (threads 0..C-1): x_i = δ_ij - Σ_{l<i} β_i Â_il x_l.
__device__ __forceinline__ void invert(const float (*a_hat)[C + 1], const float* beta,
                                       float (*tri)[C + 1]) {
  const int j = threadIdx.x;
  if (j >= C) return;
  float x[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < i; ++l) acc += a_hat[i][l] * x[l];
    x[i] = (i == j ? 1.f : 0.f) - beta[i] * acc;
    tri[i][j] = x[i];
  }
}

struct FwdIntraSmem {
  Chunk ch;
  float a_hat[C][C + 1], m[C][C + 1], tri[C][C + 1];
};

__global__ void __launch_bounds__(THREADS)
    kda_fwd_intra_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ beta, bf16* __restrict__ w,
                         float* __restrict__ ut, float* __restrict__ m, int S, int H) {
  __shared__ FwdIntraSmem sm;
  const int n = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, c = threadIdx.x;
  const int n_chunks = (S + C - 1) / C;
  float vr[C];  // channel c of V
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int tt = n * C + t;
    vr[t] = tt < S ? __bfloat162float(v[row_of(b, tt, h, S, H) * D + c]) : 0.f;
  }
  load_chunk(sm.ch, q, k, g, beta, b, n, h, S, H);
  __syncthreads();
  decay_products<true>(sm.ch, sm.a_hat, sm.m);
  __syncthreads();
  invert(sm.a_hat, sm.ch.beta, sm.tri);
  float* mo = m + ((long long)bh * n_chunks + n) * C * C;
  for (int i = c; i < C * C; i += THREADS) mo[i] = sm.m[i / C][i % C];
  __syncthreads();
  // W = T diag(β) (K ⊙ e^G) and Ũ = T diag(β) V, a column c a thread
  float bk[C], bv[C];
#pragma unroll
  for (int s = 0; s < C; ++s) {
    bk[s] = sm.ch.beta[s] * sm.ch.k[s][c] * expf(sm.ch.g[s][c]);
    bv[s] = sm.ch.beta[s] * vr[s];
  }
#pragma unroll
  for (int t = 0; t < C; ++t) {
    float wa = 0.f, ua = 0.f;
#pragma unroll
    for (int s = 0; s <= t; ++s) {
      wa += sm.tri[t][s] * bk[s];
      ua += sm.tri[t][s] * bv[s];
    }
    const int tt = n * C + t;
    if (tt < S) {
      const long long at = row_of(b, tt, h, S, H) * D + c;
      w[at] = __float2bfloat16(wa);
      ut[at] = ua;
    }
  }
}

// ------------------------------------------------------------ the state walks

// Thread c's channel of one chunk's rows, loaded ahead of their use: g
// (fp32) and two bf16 [C, D] tensors (q and k), a third (W), the
// [C, BV] fp32 slice of Ũ (forward) or bf16 slice of dO (backward) and the
// [C, C] M, each a few elements a thread.
template <typename Slice>
struct Ahead {
  float g[C];
  bf16 q[C], k[C], w[C];
  Slice x[C * BV / THREADS];
  float m[C * C / THREADS];
};

template <typename Slice>
__device__ __forceinline__ void load_ahead(Ahead<Slice>& a, const bf16* __restrict__ q,
                                           const bf16* __restrict__ k,
                                           const float* __restrict__ g,
                                           const bf16* __restrict__ w,
                                           const Slice* __restrict__ x,
                                           const float* __restrict__ m, int b, int n, int h,
                                           int bh, int v0, int S, int H, int n_chunks) {
  const int c = threadIdx.x;
  const bf16 zero = zero_of<bf16>();
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int tt = n * C + t;
    if (tt < S) {
      const long long at = row_of(b, tt, h, S, H) * D + c;
      a.g[t] = g[at];
      a.q[t] = q[at];
      a.k[t] = k[at];
      a.w[t] = w[at];
    } else {
      a.g[t] = 0.f;
      a.q[t] = a.k[t] = a.w[t] = zero;
    }
  }
#pragma unroll
  for (int j = 0; j < C * BV / THREADS; ++j) {
    const int i = c + j * THREADS, t = i / BV, col = i % BV, tt = n * C + t;
    a.x[j] = tt < S ? x[row_of(b, tt, h, S, H) * D + v0 + col] : zero_of<Slice>();
  }
  const float* mc = m + ((long long)bh * n_chunks + n) * C * C;
#pragma unroll
  for (int j = 0; j < C * C / THREADS; ++j) a.m[j] = mc[c + j * THREADS];
}

// What both walks hold in shared memory: BV columns of the state (or of
// its gradient) in fp32 and in bf16, the chunk's Q ⊙ e^G, K ⊙ e^{G_C - G}
// and W in bf16, M in bf16, e^{G_C}, and two [C, BV] slices.
struct WalkSmem {
  alignas(32) float st[D][AP];
  alignas(32) bf16 stb[D][SP];
  alignas(32) bf16 qg[C][HP];
  alignas(32) bf16 kend[C][HP];
  alignas(32) bf16 w[C][HP];
  alignas(32) bf16 mb[C][MP];
  alignas(32) bf16 xb[C][SP];  // dO (backward)
  alignas(32) bf16 yb[C][SP];  // U (forward) or dU (backward) in bf16
  alignas(32) float p0[C][AP];
  alignas(32) float p1[C][AP];
  float decay[D];
  float red[WARPS];
};

// The chunk's inputs from registers into shared memory: G summed down the
// chunk, Q ⊙ e^G, K ⊙ e^{G_C - G}, W and M in bf16, e^{G_C}.
template <typename Slice>
__device__ __forceinline__ void stage_chunk(WalkSmem& sm, const Ahead<Slice>& a) {
  const int c = threadIdx.x;
  float big_g[C];
  float cum = 0.f;
#pragma unroll
  for (int t = 0; t < C; ++t) {
    cum += a.g[t];
    big_g[t] = cum;
  }
  const float last = big_g[C - 1];
#pragma unroll
  for (int t = 0; t < C; ++t) {
    sm.qg[t][c] = __float2bfloat16(__bfloat162float(a.q[t]) * expf(big_g[t]));
    sm.kend[t][c] = __float2bfloat16(__bfloat162float(a.k[t]) * expf(last - big_g[t]));
    sm.w[t][c] = a.w[t];
  }
  sm.decay[c] = expf(last);
#pragma unroll
  for (int j = 0; j < C * C / THREADS; ++j) {
    const int i = c + j * THREADS;
    sm.mb[i / C][i % C] = __float2bfloat16(a.m[j]);
  }
}

// Store the state's BV columns (fp32) at its chunk slot and keep a bf16 copy.
__device__ __forceinline__ void store_state(WalkSmem& sm, float* __restrict__ out, int bh,
                                            int n, int v0, int n_chunks) {
  float* base = out + ((long long)bh * n_chunks + n) * D * D + v0;
  for (int i = threadIdx.x; i < D * BV; i += THREADS) {
    const int r = i / BV, col = i % BV;
    const float x = sm.st[r][col];
    base[(long long)r * D + col] = x;
    sm.stb[r][col] = __float2bfloat16(x);
  }
}

__device__ __forceinline__ void scale_state(WalkSmem& sm) {
  for (int i = threadIdx.x; i < D * BV; i += THREADS) {
    const int r = i / BV, col = i % BV;
    sm.st[r][col] *= sm.decay[r];
  }
}

__global__ void __launch_bounds__(THREADS)
    kda_fwd_state_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const float* __restrict__ g, const bf16* __restrict__ w,
                         float* __restrict__ u, const float* __restrict__ m,
                         bf16* __restrict__ o, float* __restrict__ s0,
                         float* __restrict__ ss, int S, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WalkSmem& sm = *reinterpret_cast<WalkSmem*>(smem_raw);
  const int bh = blockIdx.x, iv = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, v0 = iv * BV;
  const int n_chunks = (S + C - 1) / C;
  for (int i = tid; i < D * BV; i += THREADS) sm.st[i / BV][i % BV] = 0.f;
  Ahead<float> a;
  load_ahead(a, q, k, g, w, u, m, b, 0, h, bh, v0, S, H, n_chunks);
  __syncthreads();
  for (int n = 0; n < n_chunks; ++n) {
    store_state(sm, s0, bh, n, v0, n_chunks);
    stage_chunk(sm, a);
    float ut[C * BV / THREADS];
#pragma unroll
    for (int j = 0; j < C * BV / THREADS; ++j) ut[j] = a.x[j];
    if (n + 1 < n_chunks) load_ahead(a, q, k, g, w, u, m, b, n + 1, h, bh, v0, S, H, n_chunks);
    __syncthreads();
    {  // warps 0-1: W S_0 into p0; warps 2-3: (Q ⊙ e^G) S_0 into p1; a 16-column tile each
      const int j = warp & 1;
      const bf16* lhs = warp < 2 ? &sm.w[0][0] : &sm.qg[0][0];
      Acc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, lhs + kk * 16, HP);
        wmma::load_matrix_sync(fb, &sm.stb[kk * 16][j * 16], SP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(warp < 2 ? &sm.p0[0][j * 16] : &sm.p1[0][j * 16], acc, AP,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // U = Ũ - W S_0 over Ũ, and in bf16; the state decays by e^{G_C}
#pragma unroll
    for (int j = 0; j < C * BV / THREADS; ++j) {
      const int i = tid + j * THREADS, t = i / BV, col = i % BV, tt = n * C + t;
      const float uu = ut[j] - sm.p0[t][col];
      sm.yb[t][col] = __float2bfloat16(uu);
      if (tt < S) u[row_of(b, tt, h, S, H) * D + v0 + col] = uu;
    }
    scale_state(sm);
    __syncthreads();
    // S_C = e^{G_C} S_0 + (K ⊙ e^{G_C - G})ᵀ U: 16 tiles of the state, four
    // a warp; warps 0-1 also add M U to (Q ⊙ e^G) S_0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tile = warp * 4 + i, rt = tile >> 1, ct = tile & 1;
      Acc acc;
      FragAt fa;
      FragB fb;
      wmma::load_matrix_sync(acc, &sm.st[rt * 16][ct * 16], AP, wmma::mem_row_major);
      wmma::load_matrix_sync(fa, &sm.kend[0][rt * 16], HP);
      wmma::load_matrix_sync(fb, &sm.yb[0][ct * 16], SP);
      wmma::mma_sync(acc, fa, fb, acc);
      wmma::store_matrix_sync(&sm.st[rt * 16][ct * 16], acc, AP, wmma::mem_row_major);
    }
    if (warp < 2) {
      Acc acc;
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(acc, &sm.p1[0][warp * 16], AP, wmma::mem_row_major);
      wmma::load_matrix_sync(fa, &sm.mb[0][0], MP);
      wmma::load_matrix_sync(fb, &sm.yb[0][warp * 16], SP);
      wmma::mma_sync(acc, fa, fb, acc);
      wmma::store_matrix_sync(&sm.p1[0][warp * 16], acc, AP, wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < C * BV / THREADS; ++j) {
      const int i = tid + j * THREADS, t = i / BV, col = i % BV, tt = n * C + t;
      if (tt < S) o[row_of(b, tt, h, S, H) * D + v0 + col] = __float2bfloat16(scale * sm.p1[t][col]);
    }
  }
  // the final state's sum of squares, in a fixed order
  float sq = 0.f;
  for (int i = tid; i < D * BV; i += THREADS) {
    const float x = sm.st[i / BV][i % BV];
    sq += x * x;
  }
  sq = warp_sum(sq);
  if ((tid & 31) == 0) sm.red[warp] = sq;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < WARPS; ++i) total += sm.red[i];
    ss[bh * gridDim.y + iv] = total;
  }
}

__global__ void __launch_bounds__(THREADS)
    kda_bwd_state_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const float* __restrict__ g, const bf16* __restrict__ w,
                         const float* __restrict__ m, const bf16* __restrict__ dout,
                         float* __restrict__ dh, float* __restrict__ du, int S, int H,
                         float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WalkSmem& sm = *reinterpret_cast<WalkSmem*>(smem_raw);
  const int bh = blockIdx.x, iv = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, v0 = iv * BV;
  const int n_chunks = (S + C - 1) / C;
  for (int i = tid; i < D * BV; i += THREADS) sm.st[i / BV][i % BV] = 0.f;
  Ahead<bf16> a;
  load_ahead(a, q, k, g, w, dout, m, b, n_chunks - 1, h, bh, v0, S, H, n_chunks);
  __syncthreads();
  for (int n = n_chunks - 1; n >= 0; --n) {
    store_state(sm, dh, bh, n, v0, n_chunks);
    stage_chunk(sm, a);
#pragma unroll
    for (int j = 0; j < C * BV / THREADS; ++j) {
      const int i = tid + j * THREADS;
      sm.xb[i / BV][i % BV] = a.x[j];
    }
    if (n > 0) load_ahead(a, q, k, g, w, dout, m, b, n - 1, h, bh, v0, S, H, n_chunks);
    __syncthreads();
    if (warp < 2) {  // dU = scale Mᵀ dO + (K ⊙ e^{G_C - G}) dS, a 16-column tile a warp
      const int j = warp;
      Acc acc, mdo;
      wmma::fill_fragment(acc, 0.f);
      wmma::fill_fragment(mdo, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, &sm.kend[0][kk * 16], HP);
        wmma::load_matrix_sync(fb, &sm.stb[kk * 16][j * 16], SP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      FragAt fm;
      FragB fd;
      wmma::load_matrix_sync(fm, &sm.mb[0][0], MP);
      wmma::load_matrix_sync(fd, &sm.xb[0][j * 16], SP);
      wmma::mma_sync(mdo, fm, fd, mdo);
#pragma unroll
      for (int e = 0; e < acc.num_elements; ++e) acc.x[e] = scale * mdo.x[e] + acc.x[e];
      wmma::store_matrix_sync(&sm.p0[0][j * 16], acc, AP, wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < C * BV / THREADS; ++j) {
      const int i = tid + j * THREADS, t = i / BV, col = i % BV, tt = n * C + t;
      const float x = sm.p0[t][col];
      sm.yb[t][col] = __float2bfloat16(x);
      if (tt < S) du[row_of(b, tt, h, S, H) * D + v0 + col] = x;
    }
    scale_state(sm);
    __syncthreads();
    // dS_0 = e^{G_C} dS + scale (Q ⊙ e^G)ᵀ dO - Wᵀ dU: 16 tiles, four a warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tile = warp * 4 + i, rt = tile >> 1, ct = tile & 1;
      Acc acc, qdo, wdu;
      FragAt fa;
      FragB fb;
      wmma::fill_fragment(qdo, 0.f);
      wmma::fill_fragment(wdu, 0.f);
      wmma::load_matrix_sync(fa, &sm.qg[0][rt * 16], HP);
      wmma::load_matrix_sync(fb, &sm.xb[0][ct * 16], SP);
      wmma::mma_sync(qdo, fa, fb, qdo);
      wmma::load_matrix_sync(fa, &sm.w[0][rt * 16], HP);
      wmma::load_matrix_sync(fb, &sm.yb[0][ct * 16], SP);
      wmma::mma_sync(wdu, fa, fb, wdu);
      wmma::load_matrix_sync(acc, &sm.st[rt * 16][ct * 16], AP, wmma::mem_row_major);
#pragma unroll
      for (int e = 0; e < acc.num_elements; ++e)
        acc.x[e] = acc.x[e] + scale * qdo.x[e] - wdu.x[e];
      wmma::store_matrix_sync(&sm.st[rt * 16][ct * 16], acc, AP, wmma::mem_row_major);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ backward intra

struct BwdIntraSmem {
  Chunk ch;
  float a_hat[C][C + 1], tri[C][C + 1], da[C][C + 1], x[C][C + 1];
  alignas(32) float dm[C][C];
  float u[C][FP];    // U (fp32), for dA
  float dbv[C][FP];  // dB_V = Tᵀ dU (fp32), for dA
  alignas(32) bf16 dob[C][HP];
  alignas(32) bf16 ub[C][HP];
  alignas(32) bf16 dub[C][HP];
  alignas(32) bf16 s0b[D][SP];  // 32 columns of S_0 in bf16
  alignas(32) bf16 dhb[D][SP];  // the same columns of dS
  alignas(32) float res[3][C][RP];  // dO S_0ᵀ, dU S_0ᵀ, U dSᵀ
  float dgend[D];                  // Σ_v S_0 ⊙ dS, a row a channel
  float red[WARPS][C];             // per-warp sums of dβ
  float dbeta[C];                  // dβ's Σ_s dA Â part
};

__global__ void __launch_bounds__(THREADS)
    kda_bwd_intra_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ beta, const float* __restrict__ s0,
                         const float* __restrict__ dh, const float* __restrict__ u,
                         const float* __restrict__ du, const bf16* __restrict__ dout,
                         bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ dg, float* __restrict__ dbeta, int S, int H,
                         float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdIntraSmem& sm = *reinterpret_cast<BwdIntraSmem*>(smem_raw);
  const int n = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c = threadIdx.x, warp = c / 32, lane = c % 32;
  const int n_chunks = (S + C - 1) / C;
  const bf16 zero = zero_of<bf16>();
  // channel c of V and dU in registers; U, dU and dO into shared memory
  float vr[C], dur[C];
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int tt = n * C + t;
    float vv = 0.f, uu = 0.f, dd = 0.f;
    bf16 oo = zero;
    if (tt < S) {
      const long long at = row_of(b, tt, h, S, H) * D + c;
      vv = __bfloat162float(v[at]);
      uu = u[at];
      dd = du[at];
      oo = dout[at];
    }
    vr[t] = vv;
    dur[t] = dd;
    sm.u[t][c] = uu;
    sm.ub[t][c] = __float2bfloat16(uu);
    sm.dub[t][c] = __float2bfloat16(dd);
    sm.dob[t][c] = oo;
  }
  sm.dgend[c] = 0.f;
  load_chunk(sm.ch, q, k, g, beta, b, n, h, S, H);
  __syncthreads();
  decay_products<false>(sm.ch, sm.a_hat, nullptr);
  if (warp == 1) {  // dO Uᵀ (scaled and masked to s <= t below)
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, &sm.dob[0][kk * 16], HP);
      wmma::load_matrix_sync(fb, &sm.ub[0][kk * 16], HP);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(&sm.dm[0][0], acc, C, wmma::mem_row_major);
  }
  __syncthreads();
  invert(sm.a_hat, sm.ch.beta, sm.tri);
  __syncthreads();
  // dB_V = Tᵀ dU, a column a thread: dv = β dB_V, and dβ's Σ_c dB_V ⊙ V
  float part[C];
#pragma unroll
  for (int s = 0; s < C; ++s) {
    float acc = 0.f;
#pragma unroll
    for (int t = s; t < C; ++t) acc += sm.tri[t][s] * dur[t];
    sm.dbv[s][c] = acc;
    part[s] = acc * vr[s];
    const int tt = n * C + s;
    if (tt < S) dv[row_of(b, tt, h, S, H) * D + c] = __float2bfloat16(sm.ch.beta[s] * acc);
  }
  __syncthreads();
  {  // dA = -dB_V Uᵀ (s < t), X = diag(β) dA; pairs as in decay_products
    const int s = c & (C - 1), t0 = c >> 4, t1 = t0 + 8;
    float d0 = 0.f, d1 = 0.f;
    for (int j = 0; j < D; ++j) {
      const float us = sm.u[s][j];
      d0 += sm.dbv[t0][j] * us;
      d1 += sm.dbv[t1][j] * us;
    }
    d0 = s < t0 ? -d0 : 0.f;
    d1 = s < t1 ? -d1 : 0.f;
    sm.da[t0][s] = d0;
    sm.da[t1][s] = d1;
    sm.x[t0][s] = sm.ch.beta[t0] * d0;
    sm.x[t1][s] = sm.ch.beta[t1] * d1;
    // dM = scale dO Uᵀ on and below the diagonal
    sm.dm[t0][s] = s <= t0 ? scale * sm.dm[t0][s] : 0.f;
    sm.dm[t1][s] = s <= t1 ? scale * sm.dm[t1][s] : 0.f;
  }
  __syncthreads();
  if (c < C) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < C; ++s) acc += sm.da[c][s] * sm.a_hat[c][s];
    sm.dbeta[c] = acc;
  }
  // dO S_0ᵀ, dU S_0ᵀ and U dSᵀ ([C, D] each) over 32-column slices of the
  // states: warp w holds tiles 6w .. 6w + 5 of the 24 (product p = tile / 8,
  // 16 channels ct = tile % 8); Σ_v S_0 ⊙ dS on the way, a row r per warp
  // and lane partials reduced at the end
  Acc acc[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) wmma::fill_fragment(acc[i], 0.f);
  float dgp[D / WARPS];
#pragma unroll
  for (int j = 0; j < D / WARPS; ++j) dgp[j] = 0.f;
  const long long sbase = ((long long)bh * n_chunks + n) * D * D;
  for (int vb = 0; vb < D / BV; ++vb) {
#pragma unroll
    for (int j = 0; j < D / WARPS; ++j) {
      const int r = warp + WARPS * j;
      const long long at = sbase + (long long)r * D + vb * BV + lane;
      const float sv = s0[at], hv = dh[at];
      sm.s0b[r][lane] = __float2bfloat16(sv);
      sm.dhb[r][lane] = __float2bfloat16(hv);
      dgp[j] += sv * hv;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int tile = warp * 6 + i, p = tile / 8, ct = tile % 8;
      const bf16* lhs = p == 0 ? &sm.dob[0][0] : p == 1 ? &sm.dub[0][0] : &sm.ub[0][0];
      const bf16* rhs = p == 2 ? &sm.dhb[ct * 16][0] : &sm.s0b[ct * 16][0];
#pragma unroll
      for (int kk = 0; kk < BV / 16; ++kk) {
        FragA fa;
        FragBt fb;
        wmma::load_matrix_sync(fa, lhs + vb * BV + kk * 16, HP);
        wmma::load_matrix_sync(fb, rhs + kk * 16, SP);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int tile = warp * 6 + i, p = tile / 8, ct = tile % 8;
    wmma::store_matrix_sync(&sm.res[p][0][ct * 16], acc[i], RP, wmma::mem_row_major);
  }
#pragma unroll
  for (int j = 0; j < D / WARPS; ++j) {
    const float x = warp_sum(dgp[j]);
    if (lane == 0) sm.dgend[warp + WARPS * j] = x;
  }
  __syncthreads();
  // channel c: the per-channel products of A and M, R1_t = Σ_s X_ts k_s
  // E_ts, R2_t = Σ_s dM_ts k_s E_ts, Col_s = Σ_t (X_ts k_t + dM_ts q_t) E_ts
  float gc[C], kc[C], qc[C], r1[C], r2[C], col[C];
#pragma unroll
  for (int t = 0; t < C; ++t) {
    gc[t] = sm.ch.g[t][c];
    kc[t] = sm.ch.k[t][c];
    qc[t] = sm.ch.q[t][c];
    r1[t] = r2[t] = col[t] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < C; ++t) {
#pragma unroll
    for (int s = 0; s <= t; ++s) {
      const float e = expf(gc[t] - gc[s]);
      const float xts = sm.x[t][s], dmts = sm.dm[t][s];
      r1[t] += xts * kc[s] * e;
      r2[t] += dmts * kc[s] * e;
      col[s] += (xts * kc[t] + dmts * qc[t]) * e;
    }
  }
  // dB_K = Tᵀ dW with dW = -dU S_0ᵀ; then dq, dk, the gradient of G and dβ
  const float last = gc[C - 1];
  float dlast = sm.dgend[c] * expf(last);
  float dbig[C];
#pragma unroll
  for (int s = 0; s < C; ++s) {
    float dbk = 0.f;
#pragma unroll
    for (int t = s; t < C; ++t) dbk -= sm.tri[t][s] * sm.res[1][t][c];
    const float eg = expf(gc[s]), eend = expf(last - gc[s]);
    const float dqg = scale * sm.res[0][s][c], dkend = sm.res[2][s][c];
    const float kg = kc[s] * eg, kend = kc[s] * eend, dkg = sm.ch.beta[s] * dbk;
    part[s] += dbk * kg;
    dbig[s] = kc[s] * (r1[s] - col[s]) + qc[s] * r2[s] + dqg * qc[s] * eg + dkg * kg -
              dkend * kend;
    dlast += dkend * kend;
    const int tt = n * C + s;
    if (tt < S) {
      const long long at = row_of(b, tt, h, S, H) * D + c;
      dq[at] = __float2bfloat16(dqg * eg + r2[s]);
      dk[at] = __float2bfloat16(r1[s] + col[s] + dkg * eg + dkend * eend);
    }
  }
  float rev = 0.f;
#pragma unroll
  for (int t = C - 1; t >= 0; --t) {
    rev += dbig[t];
    const int tt = n * C + t;
    if (tt < S) dg[row_of(b, tt, h, S, H) * D + c] = rev + dlast;
  }
  // dβ: the channels' parts summed a warp at a time, then the warps in order
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const float x = warp_sum(part[t]);
    if (lane == 0) sm.red[warp][t] = x;
  }
  __syncthreads();
  if (c < C) {
    float acc = sm.dbeta[c];
    for (int i = 0; i < WARPS; ++i) acc += sm.red[i][c];
    const int tt = n * C + c;
    if (tt < S) dbeta[row_of(b, tt, h, S, H)] = acc;
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
cudaError_t set_smem_limit(Kernel kernel, int smem_bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

}  // namespace

// Plain C interface (loaded with ctypes): contiguous tensors in the layout
// above; every entry point returns cudaGetLastError() after its launch. The
// shared-memory limit of each kernel is raised once (not per launch, so
// launches can be captured into a CUDA graph).
extern "C" {

int kda_fwd_intra(const void* q, const void* k, const void* v, const void* g, const void* beta,
                  void* w, void* ut, void* m, int B, int S, int H, void* stream) {
  dim3 grid((S + C - 1) / C, B * H);
  kda_fwd_intra_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)g, (const float*)beta,
      (bf16*)w, (float*)ut, (float*)m, S, H);
  return (int)cudaGetLastError();
}

int kda_fwd_state(const void* q, const void* k, const void* g, const void* w, void* u,
                  const void* m, void* o, void* s0, void* ss, int B, int S, int H, float scale,
                  void* stream) {
  static const cudaError_t limit = set_smem_limit(kda_fwd_state_kernel, sizeof(WalkSmem));
  if (limit != cudaSuccess) return (int)limit;
  dim3 grid(B * H, D / BV);
  kda_fwd_state_kernel<<<grid, THREADS, sizeof(WalkSmem), (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const float*)g, (const bf16*)w, (float*)u,
      (const float*)m, (bf16*)o, (float*)s0, (float*)ss, S, H, scale);
  return (int)cudaGetLastError();
}

int kda_bwd_state(const void* q, const void* k, const void* g, const void* w, const void* m,
                  const void* dout, void* dh, void* du, int B, int S, int H, float scale,
                  void* stream) {
  static const cudaError_t limit = set_smem_limit(kda_bwd_state_kernel, sizeof(WalkSmem));
  if (limit != cudaSuccess) return (int)limit;
  dim3 grid(B * H, D / BV);
  kda_bwd_state_kernel<<<grid, THREADS, sizeof(WalkSmem), (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const float*)g, (const bf16*)w, (const float*)m,
      (const bf16*)dout, (float*)dh, (float*)du, S, H, scale);
  return (int)cudaGetLastError();
}

int kda_bwd_intra(const void* q, const void* k, const void* v, const void* g, const void* beta,
                  const void* s0, const void* dh, const void* u, const void* du,
                  const void* dout, void* dq, void* dk, void* dv, void* dg, void* dbeta, int B,
                  int S, int H, float scale, void* stream) {
  static const cudaError_t limit =
      set_smem_limit(kda_bwd_intra_kernel, sizeof(BwdIntraSmem));
  if (limit != cudaSuccess) return (int)limit;
  dim3 grid((S + C - 1) / C, B * H);
  kda_bwd_intra_kernel<<<grid, THREADS, sizeof(BwdIntraSmem), (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)g, (const float*)beta,
      (const float*)s0, (const float*)dh, (const float*)u, (const float*)du,
      (const bf16*)dout, (bf16*)dq, (bf16*)dk, (bf16*)dv, (float*)dg, (float*)dbeta, S, H,
      scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
