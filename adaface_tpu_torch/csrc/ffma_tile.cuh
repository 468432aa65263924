// The cp.async primitives of the fp32 FFMA GEMMs (ln_geglu_ff_fp32.cu,
// winograd_fp32.cu): each thread copies 16-byte pieces of its operands into
// its own slots of a shared-memory ring, commits them as a group, and
// waits for its groups with cp.async.wait_group (each kernel's own wait,
// at its ring's depth), so the ring needs no barrier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ffma_tile {

// 16 bytes from src to dst (shared memory), or 16 zero bytes where !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

}  // namespace ffma_tile
