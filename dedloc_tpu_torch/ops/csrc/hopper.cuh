// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// mbarriers, TMA tile loads, named barriers, wgmma descriptors and
// instructions, register rebalancing, and the host-side tensor-map encoder
// (looked up through the CUDA runtime, so a library needs no -lcuda).
//
// Shared-memory tiles follow wgmma's canonical swizzled layouts. A tile of
// R rows by D bf16 columns is stored as D / CW column chunks, each chunk
// [R rows][CW columns] with CW * 2 bytes per row, swizzled by TMA in the
// mode of that row width (CW = 64: 128-byte swizzle, 32: 64-byte, 16:
// 32-byte). Read with its columns as K (K-major) it is the operand of a
// score product; read with its rows as K (MN-major, the transpose bit) it is
// the B operand of a gradient product.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------ shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spins until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --------------------------------------------------------------------- TMA

// one box of a 4-D tensor map into shared memory; completion (its bytes) is
// reported to the mbarrier. Out-of-bounds elements are written as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ----------------------------------------------------------- named barriers

// barrier `id` (1-15; 0 is __syncthreads) over THREADS threads: sync waits
// for the count, arrive adds to it and goes on
template <int THREADS>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

template <int THREADS>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

// ------------------------------------------------------ register rebalancing

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --------------------------------------------------------------------- wgmma

// The swizzle of a tile whose rows are CW bf16 wide, as wgmma's descriptor
// encodes it (1: 128-byte, 2: 64-byte, 3: 32-byte)
template <int CW>
__host__ __device__ constexpr uint64_t layout_type() {
  static_assert(CW == 64 || CW == 32 || CW == 16, "chunk width");
  return CW == 64 ? 1 : CW == 32 ? 2 : 3;
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: rows [row0, row0 + 64) (A) or of the whole N (B) of a tile
// of ROWS rows, k step kk (columns [16 kk, 16 kk + 16)). Core matrices are 8
// rows x 16 bytes; 8-row groups are 8 * CW * 2 bytes apart (SBO); the
// leading offset is unused by the swizzled modes.
template <int CW, int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int row0, int kk) {
  const uint32_t addr = tile + ((kk * 16) / CW) * (ROWS * CW * 2) + row0 * (CW * 2) +
                        ((kk * 16) % CW) * 2;
  return make_desc(addr, 16, 8 * CW * 2, layout_type<CW>());
}

// MN-major B operand (transpose bit set): the tile's rows are K, its
// columns N. k step kk takes rows [16 kk, 16 kk + 16); the instruction's N
// range starts at column n0 (a multiple of CW). 8-row groups along K are
// 8 * CW * 2 bytes apart (SBO); column chunks along N are ROWS * CW * 2
// bytes apart (LBO).
template <int CW, int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk, int n0) {
  const uint32_t addr = tile + (n0 / CW) * (ROWS * CW * 2) + kk * 16 * (CW * 2);
  return make_desc(addr, ROWS * CW * 2, 8 * CW * 2, layout_type<CW>());
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in place around the asynchronous products: the compiler
// may neither read an accumulator before the wait nor reuse an A register
// while a product still reads it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The accumulator of m64nNk16 (f32): in each warp of the warpgroup, thread
// (g = lane / 4, t = lane % 4) holds, for every 8-column group j,
// d[4j], d[4j+1] at row 16 warp + g, columns 8j + 2t, +1, and d[4j+2],
// d[4j+3] at row 16 warp + g + 8: per warp, mma.sync m16n8k16's C layout.
// The A operand from registers has mma.sync's A layout per warp.

#define HOPPER_F8(o)                                                              \
  "+f"(d[OFF + o + 0]), "+f"(d[OFF + o + 1]), "+f"(d[OFF + o + 2]), "+f"(d[OFF + o + 3]), \
      "+f"(d[OFF + o + 4]), "+f"(d[OFF + o + 5]), "+f"(d[OFF + o + 6]), "+f"(d[OFF + o + 7])

// D[64 x N] (+)= A[64 x 16] . B[N x 16]^T, both from shared memory, K-major
// (N = 64 or 128)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  constexpr int OFF = 0;
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    static_assert(N == 128, "wgmma N");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24), HOPPER_F8(32),
          HOPPER_F8(40), HOPPER_F8(48), HOPPER_F8(56)
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// D[64 x N] += A[64 x 16] (registers) . B[16 x N] (shared memory, MN-major)
template <int N, int OFF, int NACC>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[NACC], const uint32_t (&a)[4],
                                           uint64_t db) {
  static_assert(OFF + N / 2 <= NACC, "accumulator range");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : HOPPER_F8(0), HOPPER_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 16, "wgmma N");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : HOPPER_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

#undef HOPPER_F8

// D[64 x DN] += A[64 x 16] . B where B is rows [16 kk, +16) of a ROWS x DN
// MN-major tile: one instruction per piece of N (64, then 32, then 16 wide)
template <int DN, int CW, int ROWS, int N0 = 0>
__device__ __forceinline__ void wgmma_rs_t_wide(float (&d)[DN / 2], const uint32_t (&a)[4],
                                                uint32_t tile, int kk) {
  if constexpr (N0 < DN) {
    constexpr int N = DN - N0 >= 64 ? 64 : DN - N0 >= 32 ? 32 : 16;
    static_assert(N0 % CW == 0, "a piece of N starts at a column chunk");
    wgmma_rs_t<N, N0 / 2>(d, a, desc_mnmajor<CW, ROWS>(tile, kk, N0));
    wgmma_rs_t_wide<DN, CW, ROWS, N0 + N>(d, a, tile, kk);
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

template <int CW>
constexpr CUtensorMapSwizzle tma_swizzle() {
  return CW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : CW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A map over a bf16 [B, S, H, D] tensor with element strides (b, s, h) and
// a contiguous last dimension, as the 4-D (D, H, S, B) box grid of boxes
// (CW columns, 1 head, BOX_ROWS rows, 1 sample) in the CW-wide swizzle.
template <int CW, int BOX_ROWS>
inline bool encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                        long long sb, long long ss, long long sh) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {CW, 1, BOX_ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, tma_swizzle<CW>(),
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
