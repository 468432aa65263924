// Tile helpers of the packed flash-attention backward (flash_attn_bwd.cu):
// cp.async staging of [64, D] head panels into shared memory, mma.sync
// m16n8k16 bf16 with fp32 accumulators, ldmatrix for transposed B operands;
// and the constants and small helpers the forward (flash_attn_packed.cu,
// through hopper_common.cuh) shares with it.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//                         a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..)
//   B (16x8, col-major):  b0 (k rows 2t..2t+1, col g), b1 (k rows 2t+8.., col g)
//   C (16x8):             c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// so an fp32 C tile of a product, rounded to bf16 and packed in pairs, is
// the A fragment of the next product over the same columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;       // rows per tile (queries or keys)
constexpr int WARPS = 4;       // 16 rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCORE_FLOOR = -100.0f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two transposed 8x8 b16 matrices: the B operand of X.T where T is a
// row-major [rows, D] tile and the product contracts over its rows.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Low half holds `lo` (the smaller column index), as the mma fragments expect.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of rows [row0, row0 + 16), depth columns [k0, k0 + 16) of a
// row-major shared tile with leading dimension LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0,
                                       int k0, int g, int t) {
  const bf16* p = tile + (row0 + g) * LD + k0 + t * 2;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * LD);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * LD + 8);
}

// acc[n] += A(16 rows x DP) * T[n*8 .. n*8+8, :]^T for the 8 n-tiles of a
// 64-row shared tile T: a [16, 64] product contracting over the head dim.
template <int DP, int LD>
__device__ __forceinline__ void mma_rows_by_tile(float (&acc)[TILE / 8][4],
                                                 const bf16* A, int arow0,
                                                 const bf16* T, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    load_a<LD>(a, A, arow0, kk * 16, g, t);
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
      const bf16* b = T + (n * 8 + g) * LD + kk * 16 + t * 2;
      mma_16816(acc[n], a, ld_u32(b), ld_u32(b + 8));
    }
  }
}

// acc[nd] += P(16 x 64, as 4 packed A fragments) * T (64 x DP, row-major
// shared tile): a [16, DP] product contracting over the tile's 64 rows.
template <int DP, int LD>
__device__ __forceinline__ void mma_p_by_tile(float (&acc)[DP / 8][4],
                                              const uint32_t (&pa)[TILE / 16][4],
                                              const bf16* T, int lane) {
#pragma unroll
  for (int j = 0; j < TILE / 16; ++j) {
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, T + (j * 16 + (lane & 15)) * LD + nd * 8);
      mma_16816(acc[nd], pa[j], b0, b1);
    }
  }
}

// Stage rows [row0, row0 + 64) of one head panel (D columns, row stride
// `stride` elements) into a shared tile with leading dimension LD. Rows past
// `nrows` are written as zeros.
template <int D, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0, int nrows,
                                          int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int i = tid; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool valid = row0 + r < nrows;
    const bf16* g = valid ? src + (long long)(row0 + r) * stride + c : src;
    cp_async_16(dst + r * LD + c, g, valid);
  }
}

// Zero the pad columns [D, DP) of `ntiles` consecutive 64-row tiles;
// cp.async never writes them.
template <int D, int DP, int LD>
__device__ __forceinline__ void zero_pad_columns(bf16* tiles, int ntiles, int tid) {
  if constexpr (DP > D) {
    constexpr int PADC = DP - D;
    for (int i = tid; i < ntiles * TILE * PADC; i += THREADS)
      tiles[(i / PADC) * LD + D + i % PADC] = __float2bfloat16(0.0f);
  }
}

// Store the fp32 [16, DP] accumulator of one warp (rows row0 + g, + 8) times
// `mul` as bf16 into a packed head panel; only the D real columns, only rows
// below `nrows`.
template <int D, int DP>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           const float (&acc)[DP / 8][4], float mul0,
                                           float mul1, int row0, int nrows, int t) {
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int col = nd * 8 + t * 2;
    if (col < D) {
      if (row0 < nrows)
        *reinterpret_cast<uint32_t*>(dst + row0 * stride + col) =
            pack_bf16x2(acc[nd][0] * mul0, acc[nd][1] * mul0);
      if (row0 + 8 < nrows)
        *reinterpret_cast<uint32_t*>(dst + (row0 + 8) * stride + col) =
            pack_bf16x2(acc[nd][2] * mul1, acc[nd][3] * mul1);
    }
  }
}

// Opt a kernel in to `bytes` of dynamic shared memory once per
// instantiation (thread-safe static initialisation), not on every launch.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace flash
