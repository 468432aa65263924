// A CPU emulation of the CUDA features that csrc/flash_attn_fp32.cu uses,
// for tests/test_torch_flash_fp32_emulated.py: the kernel source is
// compiled by a host C++ compiler against this header (its inline asm
// replaced by the emu_* calls below) and launched with LAUNCH. Each CTA
// runs alone, one std::thread per CUDA thread; __syncthreads and
// __syncwarp are barriers, warp shuffles go through a shared buffer, and a
// cp.async copy lands when its group is waited for (emu_land_at_issue = 0:
// a read before the wait sees the garbage the shared memory was filled
// with) or at once (1: a refill issued before every reader of the buffer is
// done overwrites what they read).
#pragma once
#include <cmath>
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
#include <mutex>
#include <atomic>
#include <condition_variable>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local uint3 threadIdx;
inline uint3 blockIdx;
inline dim3 blockDim, gridDim;
alignas(16) inline float4 smem4[232448 / 16];  // an H100 CTA's largest shared memory
inline int emu_land_at_issue = 0;

struct Barrier {
  std::mutex m; std::condition_variable cv; int n = 0, count = 0, gen = 0;
  void init(int k) { n = k; count = 0; gen = 0; }
  void wait() {
    std::unique_lock<std::mutex> l(m);
    int g = gen;
    if (++count == n) { count = 0; ++gen; cv.notify_all(); }
    else cv.wait(l, [&] { return gen != g; });
  }
};
inline Barrier emu_cta_bar, emu_warp_bar[32];
inline float emu_shfl[32][32];
inline void __syncthreads() { emu_cta_bar.wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_bar[threadIdx.x / 32].wait(); }
inline float __shfl_xor_sync(unsigned, float x, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_shfl[w][l] = x; __syncwarp();
  float y = emu_shfl[w][l ^ o]; __syncwarp();
  return y;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
typedef int cudaError_t; typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
// a launch this emulation cannot run, or a misaligned access
inline std::atomic<int> emu_error{0};
inline cudaError_t cudaGetLastError() {
  const int e = emu_error;
  emu_error = 0;
  return e;
}
struct __nv_bfloat16 { float v; };
inline __nv_bfloat16 __float2bfloat16_rn(float x) { return {x}; }
inline float __bfloat162float(__nv_bfloat16 x) { return x.v; }

struct Copy { float* d; const float* s; int n; bool valid; };
// this thread's committed copy groups, then the open one
inline thread_local std::vector<std::vector<Copy>> emu_groups;
inline void emu_do(const Copy& c) { for (int e = 0; e < c.n; ++e) c.d[e] = c.valid ? c.s[e] : 0.f; }
// float4 accesses (and 16-byte copies) must be 16-byte aligned, as on the card
inline void emu_check16(const void* p) {
  if (reinterpret_cast<uintptr_t>(p) % 16) emu_error = 74;  // cudaErrorMisalignedAddress
}
inline float4* emu_f4(float* p) { emu_check16(p); return reinterpret_cast<float4*>(p); }
inline const float4* emu_cf4(const float* p) { emu_check16(p); return reinterpret_cast<const float4*>(p); }
inline void emu_copy(float* d, const float* s, int n, bool valid) {
  if (n == 4) { emu_check16(d); emu_check16(s); }
  if (emu_land_at_issue) { emu_do({d, s, n, valid}); return; }
  if (emu_groups.empty()) emu_groups.emplace_back();
  emu_groups.back().push_back({d, s, n, valid});
}
inline void emu_commit() { if (emu_groups.empty()) emu_groups.emplace_back(); emu_groups.emplace_back(); }
inline void emu_wait(int keep) {  // all but the newest `keep` committed groups land
  int committed = (int)emu_groups.size() - 1;  // the last is open
  for (int g = 0; g < committed - keep; ++g) { for (auto& c : emu_groups[g]) emu_do(c); emu_groups[g].clear(); }
}
// kernel<<<grid, threads, smem, stream>>>(args...): the CTAs one after
// another, each CTA's threads at once.
template <class K, class... A>
void LAUNCH(K k, dim3 grid, int threads, size_t smem, cudaStream_t, const A&... a) {
  if (smem > sizeof(smem4)) {
    emu_error = cudaErrorInvalidValue;
    return;
  }
  blockDim = dim3(threads);
  gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z) for (unsigned y = 0; y < grid.y; ++y) for (unsigned x = 0; x < grid.x; ++x) {
    blockIdx = {x, y, z};
    std::memset((void*)smem4, 0x7f, smem);  // garbage: a read before a copy lands shows
    emu_cta_bar.init(threads);
    for (int w = 0; w < (threads + 31) / 32; ++w) emu_warp_bar[w].init(32);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) ts.emplace_back([&, t] {
      threadIdx = {(unsigned)t, 0, 0}; emu_groups.clear(); k(a...);
      emu_wait(0);
    });
    for (auto& t : ts) t.join();
  }
}

// The same for a kernel with no barrier, shuffle or cp.async: its threads
// one after another.
template <class K, class... A>
void LAUNCH_SEQ(K k, dim3 grid, int threads, size_t, cudaStream_t, const A&... a) {
  blockDim = dim3(threads);
  gridDim = grid;
  for (unsigned x = 0; x < grid.x; ++x) {
    blockIdx = {x, 0, 0};
    for (int t = 0; t < threads; ++t) {
      threadIdx = {(unsigned)t, 0, 0};
      k(a...);
    }
  }
}

extern "C" void emu_set_land(int x) { emu_land_at_issue = x; }
