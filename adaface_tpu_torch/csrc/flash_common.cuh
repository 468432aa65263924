// Small helpers shared by the port's kernels: cp.async copies, mma.sync
// m16n8k16 bf16 with fp32 accumulators and ldmatrix for transposed B
// operands (the Winograd conv, winograd.cu); bf16 packing, the flash
// kernels' constants and the shared-memory opt-in (flash_attn_packed.cu,
// flash_attn_bwd.cu and ln_geglu_ff.cu, through hopper_common.cuh).
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

// Opt a kernel in to `bytes` of dynamic shared memory once per
// instantiation (thread-safe static initialisation), not on every launch.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace flash
