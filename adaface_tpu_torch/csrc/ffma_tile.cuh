// Register-blocked fp32 FFMA tiles for the fp32 GEMM of K10
// (winograd_fp32.cu), the tiling of flash_attn_fp32.cu: every product an
// fp32 FFMA with fp32 accumulation, no tensor core and no TF32 (the JAX
// package asks for fp32 products). The fp32 K9 (ln_geglu_ff_fp32.cu) takes
// only its cp.async primitives.
//
// Both operands are K-major ([rows][K], K contiguous), as the GEMM reads
// them: A the activations, B the Winograd U^T. A stage is BK = 16 columns
// of K; a CTA of 256 threads
// copies its A and B rows of the stage into shared memory with 16-byte
// cp.async (double-buffered by the caller: the next stage's copies are in
// flight while this one's products run), rows LDK = 20 floats apart. Thread
// (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns tx + 16 j
// of the tile: per 4 columns of K it reads one float4 per row and per
// column (8 consecutive columns' float4 reads fall on distinct banks with
// rows 20 floats apart; the 16 threads of a row read the same float4) and
// does 4 FFMA per value read at MI = NJ = 8.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ffma_tile {

constexpr int BK = 16;       // K columns a stage
constexpr int LDK = BK + 4;  // floats between shared-memory rows (80 bytes)
constexpr int NT = 256;      // threads a CTA: 16 rows of 16

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All but the newest group of copies have landed (this thread's).
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) x columns [k0, k0 + BK) of a K-major matrix whose
// rows are `ld` floats apart into dst[ROWS][LDK]; rows at or past `rows`
// read as zeros. src and ld keep every copy 16-byte aligned (ld and k0
// multiples of 4).
template <int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long ld, int r0, int rows, int k0) {
  for (int i = threadIdx.x; i < ROWS * (BK / 4); i += NT) {
    const int r = i / (BK / 4), c4 = i % (BK / 4);
    const bool valid = r0 + r < rows;
    cp_async16(dst + r * LDK + 4 * c4, src + (long long)(valid ? r0 + r : 0) * ld + k0 + 4 * c4,
               valid);
  }
}

// acc[i][j] += sum over the stage's k of a[ty + 16 i][k] * b[tx + 16 j][k],
// k in order.
template <int MI, int NJ>
__device__ __forceinline__ void fma_tile(float (&acc)[MI][NJ], const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 4) {
    float4 av[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LDK + kk);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LDK + kk);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

}  // namespace ffma_tile
