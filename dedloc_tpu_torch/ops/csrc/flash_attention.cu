// Exact flash attention for Hopper (sm_90a): forward, and a deterministic
// two-kernel backward (dK/dV, then dQ). bf16 inputs, fp32 accumulation.
//
// Replaces the Pallas TPU kernels of dedloc_tpu/ops/flash_attention.py:
//   flash_fwd_kernel       <- _fwd_kernel (via _fwd, the pallas_call at :143)
//   flash_bwd_dkdv_kernel  \  <- _dqkv_fused_kernel (the single-tile backward,
//   flash_bwd_dq_kernel    /     pallas_call at :361), and the same function as
//                                the split _dq_kernel/_dkv_kernel pair
//
// What bounds it on an H100: at the ALBERT-large slice (B=12, S=512, H=16,
// D=64) the forward moves ~50 MB and does ~13 GFLOP, so bytes and tensor-core
// operations are nearly balanced (~15 us each); the backward does ~32 GFLOP
// and is bound by operations. The design keeps every score tile on chip:
// HBM traffic is O(S*D) per head, never O(S^2). Products run on the tensor
// cores through mma.sync m16n8k16 (bf16 x bf16 -> fp32) with operands loaded
// by ldmatrix; scores, probabilities and the output / gradient accumulators
// stay in registers, and the online softmax and the gradient elementwise work
// are fp32. No TMA, no wgmma, no warp specialisation yet.
//
// Design, against the TPU kernel:
// - The TPU grid ran the KV axis sequentially and carried (acc, m, l) in VMEM
//   scratch. Here one block owns one (batch*head, 64-query tile) and loops
//   over 64-key tiles itself; each of its 4 warps owns 16 query rows and
//   keeps their accumulator and running max / sum in registers, so after the
//   K/V tile lands in shared memory a warp needs no block barrier.
// - The fused TPU backward kept one 512x512 fp32 score tile per head in VMEM
//   (1 MB), which does not fit in 227 KB of shared memory. The backward is
//   therefore tiled as two kernels that recompute p = exp(s - lse): dK/dV with
//   one block per key tile looping over query tiles, and dQ with one block per
//   query tile looping over key tiles. Each output tile has one owner, so
//   there are no atomics and the result is deterministic.
// - Layout: q, k, v, out, dO, dq, dk, dv are [B, S, H, D] read through their
//   strides (the last dimension contiguous); the bias is a per-key additive
//   [B, S] row indexed by bh / H; lse and delta are [B*H, S] fp32.
// - Numerics follow the TPU kernel: s = (q.k) * scale + bias in fp32; the
//   running max starts at -1e30 with no -inf special case, so a row whose keys
//   are all masked by a finite -1e9 bias averages V uniformly; p is rounded to
//   bf16 before p.V; out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30));
//   ds = p * (dp - delta) * scale is rounded to bf16 before ds.K and ds^T.Q.
// - Keys or queries past S in the last (ragged) tile load as zeros and get
//   probability exactly 0; their outputs are not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// s[8][4] (+)= A rows [a_row0, +16) of tile a . (64 rows of tile bt)^T, over D
template <int D>
__device__ __forceinline__ void strip_abt(float (&s)[8][4], const bf16* a, int a_row0,
                                          const bf16* bt) {
  constexpr int LDH = D + PAD_H;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    load_a<LDH>(fa, a, a_row0, kk * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t fb[4];
      load_b_nk<LDH>(fb, bt, np * 16, kk * 16);
      mma16816(s[2 * np], fa, fb[0], fb[1]);
      mma16816(s[2 * np + 1], fa, fb[2], fb[3]);
    }
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

// write a warp's two rows per thread (g and g+8 of its strip) as bf16
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], int row_g, int S,
                                           bf16* dst, Strides st, int b, int h) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_g + 8 * half;
    if (row >= S) continue;
    bf16* out = dst + b * st.b + (long long)row * st.s + h * st.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

template <int D>
constexpr int fwd_smem_bytes() {
  return 3 * 64 * (D + PAD_H) * 2 + 64 * 4;
}

template <int D>
constexpr int bwd_smem_bytes() {
  return 4 * 64 * (D + PAD_H) * 2 + 2 * 64 * 4;
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

// ----------------------------------------------------------- backward dK/dV

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const bf16* __restrict__ dout, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                          Strides sdo, Strides sdk, Strides sdv, int S, int H, float scale) {
  constexpr int LDH = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + 64 * LDH;
  bf16* sQ = sV + 64 * LDH;
  bf16* sDO = sQ + 64 * LDH;
  float* sLse = reinterpret_cast<float*>(sDO + 64 * LDH);
  float* sDelta = sLse + 64;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // this warp's key rows within the tile
  const int key0 = k0 + r0 + g, key1 = key0 + 8;
  const bool kok0 = key0 < S, kok1 = key1 < S;
  const float kb0 = kok0 ? bias[(long long)b * S + key0] : 0.0f;
  const float kb1 = kok1 ? bias[(long long)b * S + key1] : 0.0f;

  load_tile<D>(sK, k, sk, b, h, k0, S);
  load_tile<D>(sV, v, sv, b, h, k0, S);

  float acc_dv[D / 8][4], acc_dk[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc_dv[j][0] = acc_dv[j][1] = acc_dv[j][2] = acc_dv[j][3] = 0.0f;
    acc_dk[j][0] = acc_dk[j][1] = acc_dk[j][2] = acc_dk[j][3] = 0.0f;
  }

  const int n_tiles = (S + BQ - 1) / BQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<D>(sQ, q, sq, b, h, q0, S);
    load_tile<D>(sDO, dout, sdo, b, h, q0, S);
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const bool ok = q0 + i < S;
      sLse[i] = ok ? lse[(long long)bh * S + q0 + i] : 0.0f;
      sDelta[i] = ok ? delta[(long long)bh * S + q0 + i] : 0.0f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];  // S^T and dP^T: key rows x query columns
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.0f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.0f;
    }
    strip_abt<D>(st, sK, r0, sQ);    // S^T = K . Q^T
    strip_abt<D>(dpt, sV, r0, sDO);  // dP^T = V . dO^T

#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const bool qok = q0 + col < S;
        const float row_lse = sLse[col], row_delta = sDelta[col];
        const float p0 = (kok0 && qok) ? expf(st[j][e] * scale + kb0 - row_lse) : 0.0f;
        const float p1 = (kok1 && qok) ? expf(st[j][2 + e] * scale + kb1 - row_lse) : 0.0f;
        dpt[j][e] = p0 * (dpt[j][e] - row_delta) * scale;
        dpt[j][2 + e] = p1 * (dpt[j][2 + e] - row_delta) * scale;
        st[j][e] = p0;
        st[j][2 + e] = p1;
      }
    }
    strip_pm<D>(acc_dv, st, sDO);  // dV += P^T . dO  (P^T rounded to bf16)
    strip_pm<D>(acc_dk, dpt, sQ);  // dK += dS^T . Q  (dS^T rounded to bf16)
  }

  const int row_g = k0 + r0 + g;
  store_rows<D>(acc_dv, row_g, S, dv, sdv, b, h);
  store_rows<D>(acc_dk, row_g, S, dk, sdk, b, h);
}

// -------------------------------------------------------------- backward dQ

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const bf16* __restrict__ dout, bf16* __restrict__ dq, Strides sq,
                        Strides sk, Strides sv, Strides sdo, Strides sdq, int S, int H,
                        float scale) {
  constexpr int LDH = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + 64 * LDH;
  bf16* sK = sDO + 64 * LDH;
  bf16* sV = sK + 64 * LDH;
  float* sBias = reinterpret_cast<float*>(sV + 64 * LDH);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // this warp's query rows within the tile
  const int qr0 = q0 + r0 + g, qr1 = qr0 + 8;
  const bool qok0 = qr0 < S, qok1 = qr1 < S;
  const float lse0 = qok0 ? lse[(long long)bh * S + qr0] : 0.0f;
  const float lse1 = qok1 ? lse[(long long)bh * S + qr1] : 0.0f;
  const float delta0 = qok0 ? delta[(long long)bh * S + qr0] : 0.0f;
  const float delta1 = qok1 ? delta[(long long)bh * S + qr1] : 0.0f;

  load_tile<D>(sQ, q, sq, b, h, q0, S);
  load_tile<D>(sDO, dout, sdo, b, h, q0, S);

  float acc_dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc_dq[j][0] = acc_dq[j][1] = acc_dq[j][2] = acc_dq[j][3] = 0.0f;

  const int n_tiles = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<D>(sK, k, sk, b, h, k0, S);
    load_tile<D>(sV, v, sv, b, h, k0, S);
    for (int i = threadIdx.x; i < BK; i += NTHREADS)
      sBias[i] = (k0 + i < S) ? bias[(long long)b * S + k0 + i] : 0.0f;
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
    strip_abt<D>(s, sQ, r0, sK);    // S = Q . K^T
    strip_abt<D>(dp, sDO, r0, sV);  // dP = dO . V^T

#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const bool kok = k0 + col < S;
        const float kb = sBias[col];
        const float p0 = (qok0 && kok) ? expf(s[j][e] * scale + kb - lse0) : 0.0f;
        const float p1 = (qok1 && kok) ? expf(s[j][2 + e] * scale + kb - lse1) : 0.0f;
        dp[j][e] = p0 * (dp[j][e] - delta0) * scale;
        dp[j][2 + e] = p1 * (dp[j][2 + e] - delta1) * scale;
      }
    }
    strip_pm<D>(acc_dq, dp, sK);  // dQ += dS . K  (dS rounded to bf16)
  }

  store_rows<D>(acc_dq, q0 + r0 + g, S, dq, sdq, b, h);
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

template <int D>
cudaError_t launch_bwd_dkdv(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                            const float* lse, const float* delta, const bf16* dout, bf16* dk,
                            bf16* dv, Strides sq, Strides sk, Strides sv, Strides sdo,
                            Strides sdk, Strides sdv, int B, int S, int H, float scale,
                            cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  // raised once per instantiation (not per launch, so launches can be
  // captured into a CUDA graph)
  static const cudaError_t limit = set_smem_limit(flash_bwd_dkdv_kernel<D>, smem);
  if (limit != cudaSuccess) return limit;
  dim3 grid(B * H, (S + BK - 1) / BK);
  flash_bwd_dkdv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, bias, lse, delta, dout, dk, dv, sq, sk, sv, sdo, sdk, sdv, S, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dq(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                          const float* lse, const float* delta, const bf16* dout, bf16* dq,
                          Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, int B,
                          int S, int H, float scale, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  // raised once per instantiation (not per launch, so launches can be
  // captured into a CUDA graph)
  static const cudaError_t limit = set_smem_limit(flash_bwd_dq_kernel<D>, smem);
  if (limit != cudaSuccess) return limit;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(q, k, v, bias, lse, delta, dout,
                                                           dq, sq, sk, sv, sdo, sdq, S, H,
                                                           scale);
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
