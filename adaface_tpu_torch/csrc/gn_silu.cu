// K8: fused GroupNorm + affine + SiLU over the channel (last) axis of a bf16
// or fp32 [B, N, C] tensor, for Hopper (sm_90a). Replaces the TPU kernel
// adaface_tpu/ops/fused_norm.py:_gn_silu_kernel, which takes the dtype it is
// given: one template, instantiated for bf16 (gn_silu_fwd) and fp32
// (gn_silu_fwd_fp32, an fp32 pipeline; scale and bias stay fp32 too).
//
// Function (fp32 throughout, one cast at the end in bf16): per image and
// group, s = sum x, ss = sum x^2 over N rows and C/G channels; mean = s /
// count, var = max(ss / count - mean^2, 0); per channel sc = scale *
// rsqrt(var + eps), sh = bias - mean * sc; out = x * sc + sh, then SiLU in
// fp32, then bf16 (fp32: no cast). SiLU is y / (1 + e^-y) with the fast exp
// and division (__expf, __fdividef): a few fp32 ulps at every y, so the
// tail y << 0, where SiLU is a small difference, keeps its relative
// accuracy (h + h tanh(h) with tanh.approx, one MUFU operation fewer, is
// 1.5e-2 off there after the bf16 cast, where this form is within its
// 3.9e-3 rounding).
//
// Bound: bytes. x is read once and out written once, 4 bytes per element in
// bf16 (2 x 2 x B*N*C at 3.35 TB/s), 8 in fp32; the B*N*C exp and
// reciprocals at the MUFU rate take two fifths of the bf16 time. The TPU
// kernel holds an image's slab in VMEM and reads it twice from there. Here
// one launch (grid (cluster, B)) gives each image a thread-block cluster of
// `cluster` CTAs (1..16, ops/fused_norm.py launch_plan) and reads x twice,
// the second time mostly from L2:
//
// 1. CTA `rank` owns rows [rank * N / cluster, (rank + 1) * N / cluster).
//    Each thread owns one column of 8 channels (one 16-byte word in bf16,
//    two in fp32: the same thread layout and group bookkeeping) and one row
//    lane (threads = row lanes x C/8, so a block step covers rp whole rows,
//    one contiguous run of memory; C up to 4096 takes the 512-thread
//    launch, C up to 8192 one row lane of C/8 threads, at most 64 registers
//    both) and sums x and x^2 per channel over its rows, DEPTH 16-byte loads
//    in flight (half as many rows in fp32, so the bytes in flight and the
//    registers stay those of bf16). The row lanes' sums meet in shared
//    memory, and a warp per group adds them into the CTA's [2, G] partial
//    (a fixed order: lanes stride over the group's (lane, channel) pairs,
//    then a shuffle tree).
// 2. barrier.cluster (arrive.release, wait.acquire). Every CTA then reads
//    all the cluster's partials (mapa + ld.shared::cluster, all at once)
//    and adds them in rank order, so every CTA gets the same statistics and
//    a run repeats bit for bit: no atomic add goes into any sum. A second
//    cluster barrier, arrived at once the peers are read and waited on
//    before exit, keeps each CTA's partial alive while peers read it.
// 3. Each thread forms sc, sh for its 8 channels in registers and
//    normalises its rows, NORM_DEPTH loads in flight, last read first: the
//    rows it read last are the likeliest still in L2, so where the
//    resident CTAs' rows fit the 50 MB L2 (B16 x 4096 x 320 is 42 MB) the
//    second read does not reach HBM.
//
// Holding an image's rows in the cluster's shared memory (one read, as the
// TPU kernel does) measured slower at every shape: at most 7 clusters of 16
// CTAs with 164 KB each are resident, and filling shared memory took twice
// the loads' time (PERF.md, section 6, the K8 step table). No scratch
// memory: the partials live in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using hopper::smem_addr;

constexpr int VEC = 8;           // channels a thread owns in a row
constexpr int DEPTH = 8;         // 16-byte loads a thread keeps in flight as it sums
constexpr int NORM_DEPTH = 4;    // as it normalises (8 spill, at 64 registers)
constexpr int MAX_THREADS = 512;    // C <= 4096: rp row lanes of C/8 threads
constexpr int WIDE_THREADS = 1024;  // C <= 8192: one row lane
constexpr int MAX_CLUSTER = 16;     // non-portable cluster size

// Shared memory: the CTA's partial [2][G], the group statistics [2][G], the
// cluster's partials [MAX_CLUSTER][2][G], then the row lanes' sums [rp][C]
// fp32.
__host__ __device__ constexpr int smem_bytes(int groups, int threads) {
  return 4 * (2 + 2 + 2 * MAX_CLUSTER) * groups + 4 * VEC * threads;
}

// VEC channels of T as they lie in memory: one 16-byte word (bf16) or two
// (fp32).
template <typename T>
struct Raw8 {
  static constexpr int WORDS = VEC * (int)sizeof(T) / 16;
  uint4 w[WORDS];
};

__device__ __forceinline__ void unpack8(const Raw8<bf16>& raw, float (&f)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw.w[0]);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack8(const Raw8<float>& raw, float (&f)[VEC]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(raw.w[i].x);
    f[4 * i + 1] = __uint_as_float(raw.w[i].y);
    f[4 * i + 2] = __uint_as_float(raw.w[i].z);
    f[4 * i + 3] = __uint_as_float(raw.w[i].w);
  }
}

__device__ __forceinline__ void pack8(const float (&f)[VEC], Raw8<bf16>& raw) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw.w[0]);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
}

__device__ __forceinline__ void pack8(const float (&f)[VEC], Raw8<float>& raw) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    raw.w[i] = make_uint4(__float_as_uint(f[4 * i]), __float_as_uint(f[4 * i + 1]),
                          __float_as_uint(f[4 * i + 2]), __float_as_uint(f[4 * i + 3]));
}

template <typename T>
__device__ __forceinline__ Raw8<T> ld8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < Raw8<T>::WORDS; ++i) r.w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  return r;
}

template <typename T>
__device__ __forceinline__ void st8(T* p, const Raw8<T>& r) {
#pragma unroll
  for (int i = 0; i < Raw8<T>::WORDS; ++i) reinterpret_cast<uint4*>(p)[i] = r.w[i];
}

template <typename T>
__device__ __forceinline__ void add8(const Raw8<T>& raw, float (&s)[VEC], float (&q)[VEC]) {
  float f[VEC];
  unpack8(raw, f);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s[i] += f[i];
    q[i] = fmaf(f[i], f[i], q[i]);
  }
}

template <typename T>
__device__ __forceinline__ Raw8<T> norm8(const Raw8<T>& raw, const float (&sc)[VEC],
                                         const float (&sh)[VEC], int apply_silu) {
  float f[VEC];
  unpack8(raw, f);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    // fp32 rounds the product before the sum, as the plain version does
    const float y = Raw8<T>::WORDS == 1 ? f[j] * sc[j] + sh[j]
                                        : __fadd_rn(__fmul_rn(f[j], sc[j]), sh[j]);
    f[j] = apply_silu ? __fdividef(y, 1.f + __expf(-y)) : y;
  }
  Raw8<T> out;
  pack8(f, out);
  return out;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at `p` (this CTA's shared memory) in CTA `rank` of the cluster.
__device__ __forceinline__ float ld_peer(const float* p, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// The row lanes' channel sums acc (this thread's column v, lane lr) into
// red [rp][c], then a warp per group adds them into dst[g]: lanes stride
// over the group's rp x cg (lane, channel) pairs, then a shuffle tree.
__device__ __forceinline__ void group_sums(const float (&acc)[VEC], float* red, float* dst,
                                           int c, int groups, int rp, int v, int lr) {
  float4* r4 = reinterpret_cast<float4*>(red + lr * c + v * VEC);
  r4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  r4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  const int cg = c / groups, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;  // whole warps: rp x C/8 threads may end in a partial one
  for (int g = warp; g < groups && warp < nwarps; g += nwarps) {
    float a = 0.f;
    for (int k = lane; k < rp * cg; k += 32) a += red[(k / cg) * c + g * cg + k % cg];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane == 0) dst[g] = a;
  }
  __syncthreads();
}

// T: bf16 or float (x, scale, bias and out). THREADS: MAX_THREADS (two CTAs
// an SM) or WIDE_THREADS (one); 64 registers.
template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS, WIDE_THREADS / THREADS)
gn_silu_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               const T* __restrict__ bias, T* __restrict__ out, int n, int c, int groups,
               float inv_count, float eps, int apply_silu) {
  // rows in flight: DEPTH and NORM_DEPTH 16-byte loads, two a row in fp32,
  // where 3 rows as it sums keep 64 registers (4 spill one)
  constexpr int SUM_ROWS = Raw8<T>::WORDS == 1 ? DEPTH : 3;
  constexpr int NORM_ROWS = NORM_DEPTH / Raw8<T>::WORDS;
  extern __shared__ __align__(16) float smem[];
  float* part = smem;                             // [2][G]: sums of x, x^2
  float* gstat = part + 2 * groups;               // [2][G]: mean, rstd
  float* peers = gstat + 2 * groups;              // [cluster][2][G]
  float* red = peers + 2 * MAX_CLUSTER * groups;  // [rp][c]

  const int cs = (int)cluster_size(), rank = (int)cluster_rank();
  const int tid = threadIdx.x, cv = c / VEC, rp = blockDim.x / cv;
  const int v = tid % cv, lr = tid / cv;
  const int r0 = (int)((long long)rank * n / cs);
  const int nr = (int)((long long)(rank + 1) * n / cs) - r0;
  // this thread's rows are r0 + lr + k * rp, k = 0 .. nk - 1
  const int nk = nr > lr ? (nr - 1 - lr) / rp + 1 : 0;
  const size_t col = ((size_t)blockIdx.y * n + r0 + lr) * c + (size_t)v * VEC;
  const size_t step = (size_t)rp * c;
  const T* xs = x + col;

  float s[VEC] = {}, q[VEC] = {};
  int k = 0;
  for (; k + SUM_ROWS <= nk; k += SUM_ROWS) {
    Raw8<T> raw[SUM_ROWS];
#pragma unroll
    for (int u = 0; u < SUM_ROWS; ++u) raw[u] = ld8(xs + (k + u) * step);
#pragma unroll
    for (int u = 0; u < SUM_ROWS; ++u) add8(raw[u], s, q);
  }
  for (; k < nk; ++k) add8(ld8(xs + k * step), s, q);
  group_sums(s, red, part, c, groups, rp, v, lr);
  group_sums(q, red, part + groups, c, groups, rp, v, lr);

  // the cluster's partials, added in rank order in every CTA
  cluster_arrive();
  cluster_wait();
  for (int i = tid; i < cs * 2 * groups; i += blockDim.x)
    peers[i] = ld_peer(part + i % (2 * groups), (uint32_t)(i / (2 * groups)));
  cluster_arrive();  // done with the peers' shared memory; waited on before exit
  __syncthreads();
  for (int g = tid; g < groups; g += blockDim.x) {
    float a = 0.f, qq = 0.f;
    for (int r = 0; r < cs; ++r) {
      a += peers[r * 2 * groups + g];
      qq += peers[r * 2 * groups + groups + g];
    }
    const float mean = a * inv_count;
    // fp32 rounds E[x^2] and mean^2 before the difference, as the plain
    // version does: where the variance is a small difference (few elements
    // a group) a fused multiply-add would move it far more than an ulp
    const float var = Raw8<T>::WORDS == 1
                          ? qq * inv_count - mean * mean
                          : __fsub_rn(__fmul_rn(qq, inv_count), __fmul_rn(mean, mean));
    gstat[g] = mean;
    gstat[groups + g] = rsqrtf(fmaxf(var, 0.f) + eps);
  }
  __syncthreads();

  float sc[VEC], sh[VEC];
  {
    float fs[VEC], fb[VEC];
    unpack8(ld8(scale + v * VEC), fs);
    unpack8(ld8(bias + v * VEC), fb);
    const int cg = c / groups;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int g = (v * VEC + i) / cg;
      sc[i] = fs[i] * gstat[groups + g];
      sh[i] = Raw8<T>::WORDS == 1 ? fb[i] - gstat[g] * sc[i]
                                  : __fsub_rn(fb[i], __fmul_rn(gstat[g], sc[i]));
    }
  }
  // the rows again, last read first
  T* os = out + col;
  k = nk - 1;
  for (; k + 1 >= NORM_ROWS; k -= NORM_ROWS) {
    Raw8<T> raw[NORM_ROWS];
#pragma unroll
    for (int u = 0; u < NORM_ROWS; ++u) raw[u] = ld8(xs + (k - u) * step);
#pragma unroll
    for (int u = 0; u < NORM_ROWS; ++u)
      st8(os + (k - u) * step, norm8(raw[u], sc, sh, apply_silu));
  }
  for (; k >= 0; --k) st8(os + k * step, norm8(ld8(xs + k * step), sc, sh, apply_silu));
  cluster_wait();
}

template <typename T>
cudaError_t allow_clusters() {
  const cudaError_t e = cudaFuncSetAttribute(gn_silu_kernel<T, MAX_THREADS>,
                                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e != cudaSuccess ? e
                          : cudaFuncSetAttribute(gn_silu_kernel<T, WIDE_THREADS>,
                                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Opt every launch in to clusters of 16, once.
cudaError_t kernel_attributes() {
  static const cudaError_t attr = [] {
    const cudaError_t e = allow_clusters<bf16>();
    return e != cudaSuccess ? e : allow_clusters<float>();
  }();
  return attr;
}

// The launch configuration of one image a cluster: grid (cluster, b).
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* at, int cluster, int b, int threads,
                                  int smem, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, b);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  at->id = cudaLaunchAttributeClusterDimension;
  at->val.clusterDim.x = cluster;
  at->val.clusterDim.y = 1;
  at->val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* out, int b, int n, int c,
           int groups, int cluster, int threads, float eps, int apply_silu, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(bias);
  if (c <= 0 || groups <= 0 || c % VEC || c % groups || n <= 0 || b <= 0 || b > 65535 ||
      cluster < 1 || cluster > MAX_CLUSTER || threads < 32 || threads % (c / VEC) ||
      (threads > MAX_THREADS && (threads != c / VEC || threads > WIDE_THREADS)) ||
      (align & 15) || smem_bytes(groups, threads) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr = kernel_attributes();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg =
      cluster_config(&at, cluster, b, threads, smem_bytes(groups, threads), stream);
  const float inv_count = (float)(1.0 / ((double)n * (c / groups)));
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg,
      threads <= MAX_THREADS ? gn_silu_kernel<T, MAX_THREADS> : gn_silu_kernel<T, WIDE_THREADS>,
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(out), n, c, groups, inv_count, eps, apply_silu);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [b, n, c] bf16, contiguous; scale, bias: [c] bf16; all four
// 16-byte aligned. c a multiple of 8 and of groups. The launch plan
// (ops/fused_norm.py launch_plan): `cluster` CTAs an image (1..16) of
// `threads` threads (a multiple of c / 8, 32..512; or c / 8 itself, up to
// 1024). Returns a cudaError_t (0 on success); launches only.
extern "C" int gn_silu_fwd(const void* x, const void* scale, const void* bias, void* out,
                           int b, int n, int c, int groups, int cluster, int threads, float eps,
                           int apply_silu, void* stream) {
  return launch<bf16>(x, scale, bias, out, b, n, c, groups, cluster, threads, eps, apply_silu,
                      stream);
}

// The same on fp32 x, scale, bias and out (the plan with 4-byte elements).
extern "C" int gn_silu_fwd_fp32(const void* x, const void* scale, const void* bias, void* out,
                                int b, int n, int c, int groups, int cluster, int threads,
                                float eps, int apply_silu, void* stream) {
  return launch<float>(x, scale, bias, out, b, n, c, groups, cluster, threads, eps, apply_silu,
                       stream);
}
