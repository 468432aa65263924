// K8: fused GroupNorm + affine + SiLU over the channel (last) axis of a bf16
// [B, N, C] tensor, for Hopper (sm_90a). Replaces the TPU kernel
// adaface_tpu/ops/fused_norm.py:_gn_silu_kernel.
//
// Function (fp32 throughout, one cast at the end): per image and group,
// s = sum x, ss = sum x^2 over N rows and C/G channels; mean = s / count,
// var = max(ss / count - mean^2, 0); per channel sc = scale * rsqrt(var +
// eps), sh = bias - mean * sc; out = x * sc + sh, then SiLU in fp32, then
// bf16.
//
// Bound: bytes. x is read once and out written once, 4 bytes per element
// (2 x 2 x B*N*C at 3.35 TB/s); the B*N*C sigmoids at the MUFU exp rate
// take a fifth of that. The UNet's largest slab is one image of 4096 x 960
// (7.9 MB), far past the 227 KB of shared memory a CTA has, so the slab is
// not kept on chip as the TPU kernel keeps it in VMEM. Two launches:
//
// 1. gn_stats_kernel: CTA (chunk, b) sums a chunk of about 32K elements of
//    image b (`rows` rows, chosen by the wrapper) with 16-byte loads of 8
//    channels per thread; the threads of a CTA form cv = C/8 vector columns
//    by rp row lanes. Groups are C/32 = 10..80 channels, not a whole number
//    of 16-byte vectors at every C, so sums are kept per channel first,
//    reduced over the row lanes in shared memory, and only then summed per
//    group. Each CTA writes its chunk's [2, G] partial sums; no atomics, so
//    every sum is taken in one fixed order and a run repeats bit for bit.
// 2. gn_apply_kernel: CTA (chunk, b) reduces image b's partial sums (a warp
//    per group, in a fixed order), forms sc and sh per channel in shared
//    memory, and normalises its chunk with 16-byte loads and stores.
//
// The second read of x is an L2 hit only while the batch's slab fits the
// 50 MB L2: at B16 x 4096 x 960 (126 MB) it is not, so that shape moves 1.5x
// its bound's bytes at best.
//
// Build (nvcc -Xptxas=-v, sm_90a, CUDA 12.8): 40 registers for each kernel,
// no spills; dynamic shared memory only, at most 20 KB at C <= 2560.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int VEC = 8;  // bf16 channels per 16-byte access
constexpr int APPLY_THREADS = 256;
constexpr int STATS_ROW_THREADS = 256;  // threads per CTA the stats pass aims at
constexpr int MAX_DYNAMIC_SMEM = 48 * 1024;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[VEC]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

// partial: [B, nchunks, 2, G] fp32 (sums of x, then of x^2).
__global__ void gn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ partial,
                                int n, int c, int groups, int rows) {
  extern __shared__ float sm[];  // [2][rp][c]: per-lane channel sums of x, x^2
  const int b = blockIdx.y, chunk = blockIdx.x, nchunks = gridDim.x;
  const int cv = c / VEC, rp = blockDim.x / cv;
  const int tid = threadIdx.x, v = tid % cv, lane_row = tid / cv;
  const int r0 = chunk * rows, r1 = min(n, r0 + rows);
  float s[VEC] = {}, ss[VEC] = {};
  const bf16* xb = x + (size_t)b * n * c + v * VEC;
  for (int r = r0 + lane_row; r < r1; r += rp) {
    float f[VEC];
    unpack8(*reinterpret_cast<const uint4*>(xb + (size_t)r * c), f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] += f[i];
      ss[i] = fmaf(f[i], f[i], ss[i]);
    }
  }
  float* sq = sm + rp * c;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sm[lane_row * c + v * VEC + i] = s[i];
    sq[lane_row * c + v * VEC + i] = ss[i];
  }
  __syncthreads();
  // per channel, over the row lanes in lane order; row lane 0 keeps the sum
  for (int ch = tid; ch < c; ch += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int l = 0; l < rp; ++l) {
      a += sm[l * c + ch];
      q += sq[l * c + ch];
    }
    sm[ch] = a;
    sq[ch] = q;
  }
  __syncthreads();
  const int cg = c / groups;
  float* p = partial + (size_t)(b * nchunks + chunk) * 2 * groups;
  for (int g = tid; g < groups; g += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int k = 0; k < cg; ++k) {
      a += sm[g * cg + k];
      q += sq[g * cg + k];
    }
    p[g] = a;
    p[groups + g] = q;
  }
}

__global__ void __launch_bounds__(APPLY_THREADS)
gn_apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                const bf16* __restrict__ bias, const float* __restrict__ partial,
                bf16* __restrict__ out, int n, int c, int groups, int rows,
                float inv_count, float eps, int apply_silu) {
  extern __shared__ float sm[];  // sc[c], sh[c], mean[G], rstd[G]
  float* sc = sm;
  float* sh = sm + c;
  float* gmean = sh + c;
  float* grstd = gmean + groups;
  const int b = blockIdx.y, chunk = blockIdx.x, nchunks = gridDim.x, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const float* p = partial + (size_t)b * nchunks * 2 * groups;
  // one warp per group: lanes sum the chunks lane, lane + 32, ... and a
  // shuffle tree combines them, the same order in every CTA and every run
  for (int g = warp; g < groups; g += APPLY_THREADS / 32) {
    float a = 0.f, q = 0.f;
    for (int k = lane; k < nchunks; k += 32) {
      a += p[2 * k * groups + g];
      q += p[(2 * k + 1) * groups + g];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) {
      const float mean = a * inv_count;
      const float var = fmaxf(q * inv_count - mean * mean, 0.f);
      gmean[g] = mean;
      grstd[g] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  const int cg = c / groups;
  for (int ch = tid; ch < c; ch += blockDim.x) {
    const int g = ch / cg;
    const float s = __bfloat162float(scale[ch]) * grstd[g];
    sc[ch] = s;
    sh[ch] = __bfloat162float(bias[ch]) - gmean[g] * s;
  }
  __syncthreads();
  const int cv = c / VEC;
  const int r0 = chunk * rows, r1 = min(n, r0 + rows);
  const size_t base = ((size_t)b * n + r0) * c;
  const int nvec = (r1 - r0) * cv;
  for (int i = tid; i < nvec; i += blockDim.x) {
    const size_t e = base + (size_t)i * VEC;
    const int ch0 = (i % cv) * VEC;
    float f[VEC];
    unpack8(*reinterpret_cast<const uint4*>(x + e), f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float y = f[j] * sc[ch0 + j] + sh[ch0 + j];
      if (apply_silu) y = y / (1.f + __expf(-y));
      f[j] = y;
    }
    *reinterpret_cast<uint4*>(out + e) = pack8(f);
  }
}

}  // namespace

// x, out: [b, n, c] bf16, contiguous, 16-byte aligned; scale, bias: [c] bf16;
// partial: [b, ceil(n / rows), 2, groups] fp32 scratch. c must be a multiple
// of 8 and of groups. Returns a cudaError_t (0 on success); launches only.
extern "C" int gn_silu_fwd(const void* x, const void* scale, const void* bias,
                           void* partial, void* out, int b, int n, int c, int groups,
                           int rows, float eps, int apply_silu, void* stream) {
  if (c % VEC || c % groups || n <= 0 || rows <= 0 || b <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const int cv = c / VEC;
  const int rp = cv >= STATS_ROW_THREADS ? 1 : STATS_ROW_THREADS / cv;
  const size_t stats_smem = 2 * (size_t)rp * c * sizeof(float);
  const size_t apply_smem = (2 * (size_t)c + 2 * groups) * sizeof(float);
  if (rp * cv > 1024 || stats_smem > MAX_DYNAMIC_SMEM || apply_smem > MAX_DYNAMIC_SMEM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + rows - 1) / rows, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gn_stats_kernel<<<grid, rp * cv, stats_smem, s>>>(
      static_cast<const bf16*>(x), static_cast<float*>(partial), n, c, groups, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float inv_count = (float)(1.0 / ((double)n * (c / groups)));
  gn_apply_kernel<<<grid, APPLY_THREADS, apply_smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(bias), static_cast<const float*>(partial),
      static_cast<bf16*>(out), n, c, groups, rows, inv_count, eps, apply_silu);
  return (int)cudaGetLastError();
}
