// K9 in fp32: the UNet transformer block's feed-forward, fused, on fp32
// [M, C] rows, for Hopper (sm_90a): out = x + Linear(F -> C)(a *
// gelu_tanh(g)) with [a | g] = Linear(C -> 2F)(LayerNorm(x)). Replaces the
// TPU kernel adaface_tpu/ops/fused_ff.py:_ff_kernel where the pipeline runs
// in fp32 (the bf16 instance is ln_geglu_ff.cu, on wgmma). Function, as
// ops/fused_ff.py:ln_geglu_ff_plain computes it on fp32 inputs:
//   y = (x - mu) * rsqrt(var + eps) * ln_g + ln_b, one-pass stats
//       (mu = mean x, var = max(mean x^2 - mu^2, 0));
//   u = y . w1 + b1 (fp32 products and sums);
//   h = a * gelu_tanh(g), a and g the value and gate halves of u;
//   out = x + (h . w2 + b2).
// Every product is an fp32 FFMA with fp32 accumulation: no tensor core, no
// TF32 (the JAX package asks for fp32 products, which TF32 would not give).
//
// Bound: operations. 24 * M * C^2 FFMA flops at F = 4C against the fp32
// non-tensor peak of 67 TFLOP/s (at M = 16 * 4096, C = 320: 2.4 ms), far
// above x, out and both weights moved once (0.2 ms at 3.35 TB/s).
//
// Three launches, the simple design first:
//   ln_kernel:                 y = LN(x) [M, C] fp32, a warp a row (x read
//                              twice, the second time from L1/L2);
//   gemm_kernel<EPI_GEGLU>:    h = GEGLU(y . w1 + b1) [M, F] fp32: a CTA's
//                              B tile stacks 64 value rows (w1 rows j..) and
//                              their 64 gate rows (F + j..), so each thread
//                              holds a value column and its gate column and
//                              applies GEGLU (tanhf) in registers;
//   gemm_kernel<EPI_RESIDUAL>: out = x + (h . w2 + b2) [M, C].
// Both GEMMs are "TN" (y or h [M, K] and the nn.Linear weight [out, in],
// both K-major), 128 rows by 128 (or 64) columns a CTA of 256 threads,
// register-blocked 8 x 8 (or 8 x 4) FFMA from ffma_tile.cuh, the stages of
// 16 K columns double-buffered in shared memory by cp.async. Each output
// sums its K products in order in one thread: two launches agree bit for
// bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ffma_tile.cuh"

namespace {

using namespace ffma_tile;

constexpr int EPI_GEGLU = 0, EPI_RESIDUAL = 1;
constexpr int BM = 128;        // rows a GEMM CTA
constexpr int MI = BM / 16;    // rows a thread
constexpr int H_COLS = 64;     // h columns a GEMM1 CTA (its B tile: 2 x 64 rows)
constexpr int LN_ROWS = NT / 32;  // rows a LayerNorm CTA: a warp each

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = LN(x) * ln_g + ln_b per row; c a multiple of 4.
__global__ void __launch_bounds__(NT) ln_kernel(const float* __restrict__ x,
                                                const float* __restrict__ ln_g,
                                                const float* __restrict__ ln_b,
                                                float* __restrict__ y, int m, int c, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * LN_ROWS + threadIdx.x / 32;
  if (row >= m) return;
  const float4* xr = reinterpret_cast<const float4*>(x + row * c);
  float s = 0.f, ss = 0.f;
  for (int i = lane; i < c / 4; i += 32) {
    const float4 v = xr[i];
    s += (v.x + v.y) + (v.z + v.w);
    ss += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
  }
  const float mu = warp_sum(s) / c;
  const float var = fmaxf(warp_sum(ss) / c - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  const float4* g4 = reinterpret_cast<const float4*>(ln_g);
  const float4* b4 = reinterpret_cast<const float4*>(ln_b);
  float4* yr = reinterpret_cast<float4*>(y + row * c);
  for (int i = lane; i < c / 4; i += 32) {
    const float4 v = xr[i], g = g4[i], b = b4[i];
    yr[i] = make_float4((v.x - mu) * rstd * g.x + b.x, (v.y - mu) * rstd * g.y + b.y,
                        (v.z - mu) * rstd * g.z + b.z, (v.w - mu) * rstd * g.w + b.w);
  }
}

// gelu with the tanh approximation, as torch's F.gelu(approximate="tanh")
__device__ __forceinline__ float gelu_tanh(float g) {
  const float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
  return 0.5f * g * (1.f + tanhf(inner));
}

// EPI_GEGLU: h [M, f] = GEGLU(a [M, k] . b^T + bias), b = w1^T [2f, k]; the
// CTA's columns are h columns n0 .. n0 + 63 (BN = 128: value and gate rows).
// EPI_RESIDUAL: out [M, n] = x + (a [M, k] . b^T + bias), b = w2^T [n, k];
// the CTA's columns are n0 .. n0 + BN - 1.
template <int EPI, int BN>
__global__ void __launch_bounds__(NT) gemm_kernel(const float* __restrict__ a,
                                                  const float* __restrict__ b,
                                                  const float* __restrict__ bias,
                                                  const float* __restrict__ x,
                                                  float* __restrict__ out, int m, int n, int k,
                                                  int f) {
  constexpr int NJ = BN / 16;  // columns a thread
  __shared__ __align__(16) float sa[2][BM * LDK];
  __shared__ __align__(16) float sb[2][BN * LDK];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * (EPI == EPI_GEGLU ? H_COLS : BN);
  const int nk = k / BK;

  auto load = [&](int kt, int buf) {
    load_tile<BM>(sa[buf], a, k, m0, m, kt * BK);
    if constexpr (EPI == EPI_GEGLU) {
      load_tile<H_COLS>(sb[buf], b, k, n0, f, kt * BK);                    // value rows
      load_tile<H_COLS>(sb[buf] + H_COLS * LDK, b, k, f + n0, 2 * f, kt * BK);  // gate rows
    } else {
      load_tile<BN>(sb[buf], b, k, n0, n, kt * BK);
    }
  };

  float acc[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    fma_tile<MI, NJ>(acc, sa[kt & 1], sb[kt & 1], ty, tx);
    __syncthreads();  // the stage is read before the next copies overwrite it
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const long long row = m0 + ty + 16 * i;
    if (row >= m) continue;
    if constexpr (EPI == EPI_GEGLU) {
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j) {
        const int col = n0 + tx + 16 * j;
        const float av = acc[i][j] + bias[col];
        const float gv = acc[i][NJ / 2 + j] + bias[f + col];
        out[row * f + col] = av * gelu_tanh(gv);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + tx + 16 * j;
        out[row * n + col] = x[row * n + col] + (acc[i][j] + bias[col]);
      }
    }
  }
}

}  // namespace

// x, out: [m, c] fp32; ln_g, ln_b, b2: [c]; w1t: [2f, c] (nn.Linear's
// weight: value rows, then gate rows); b1: [2f]; w2t: [c, f]; y: [m, c] and
// h: [m, f] fp32 scratch. All contiguous and 16-byte aligned; c and f
// multiples of 64. Returns a cudaError_t (0 on success); launches only.
extern "C" int ln_geglu_ff_fp32_fwd(const void* x, const void* ln_g, const void* ln_b,
                                    const void* w1t, const void* b1, const void* w2t,
                                    const void* b2, void* y, void* h, void* out, int m, int c,
                                    int f, float eps, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(ln_g) |
                          reinterpret_cast<uintptr_t>(ln_b) | reinterpret_cast<uintptr_t>(w1t) |
                          reinterpret_cast<uintptr_t>(b1) | reinterpret_cast<uintptr_t>(w2t) |
                          reinterpret_cast<uintptr_t>(b2) | reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  if (m <= 0 || c <= 0 || f <= 0 || c % 64 || f % 64 || (align & 15) ||
      (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  ln_kernel<<<(m + LN_ROWS - 1) / LN_ROWS, NT, 0, s>>>(xf, static_cast<const float*>(ln_g),
                                                        static_cast<const float*>(ln_b), yf, m,
                                                        c, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int mblocks = (m + BM - 1) / BM;
  gemm_kernel<EPI_GEGLU, 2 * H_COLS><<<dim3(f / H_COLS, mblocks), NT, 0, s>>>(
      yf, static_cast<const float*>(w1t), static_cast<const float*>(b1), nullptr, hf, m, f, c, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* w2 = static_cast<const float*>(w2t);
  const float* bias2 = static_cast<const float*>(b2);
  float* o = static_cast<float*>(out);
  if (c % 128 == 0)
    gemm_kernel<EPI_RESIDUAL, 128><<<dim3(c / 128, mblocks), NT, 0, s>>>(hf, w2, bias2, xf, o, m,
                                                                         c, f, f);
  else
    gemm_kernel<EPI_RESIDUAL, 64><<<dim3(c / 64, mblocks), NT, 0, s>>>(hf, w2, bias2, xf, o, m,
                                                                       c, f, f);
  return (int)cudaGetLastError();
}
