// K9: the UNet transformer block's feed-forward, fused: out = x +
// Linear(F -> C)(a * gelu_tanh(g)) with [a | g] = Linear(C -> 2F)(LayerNorm(x)),
// F = 4C, on bf16 [M, C] rows, for Hopper (sm_90a). Replaces the TPU kernel
// adaface_tpu/ops/fused_ff.py:_ff_kernel, with its roundings:
//   y = bf16((x - mu) * rsqrt(var + eps) * ln_g + ln_b), one-pass fp32 stats
//       (var = max(E[x^2] - mu^2, 0));
//   u = bf16(bf16(y . w1) + b1) (fp32 accumulation, bias after the cast);
//   h = bf16(a * bf16(gelu_tanh(g))) (the value half first, then the gate);
//   out = bf16(x + bf16(bf16(h . w2) + b2)).
//
// Bound: operations. 24 * M * C^2 flops (2*M*C*2F + 2*M*F*C) on the tensor
// cores at 989 TFLOP/s against x in, out and both weights once at 3.35 TB/s:
// at M = 16 * 4096, C = 320 that is 0.163 ms of flops against 0.027 ms of
// bytes.
//
// Design (b) of the two the port weighed, GEMM1 + GEGLU writing h [M, F]
// bf16 to device memory and GEMM2 + b2 + residual reading it, with the
// LayerNorm as a small launch of its own before them:
//   ln_kernel:   y = LN(x) [M, C] bf16, one warp per row;
//   gemm_kernel<EPI_GEGLU>:    h = GEGLU(y . w1 + b1) [M, F];
//   gemm_kernel<EPI_RESIDUAL>: out = x + (h . w2 + b2) [M, C].
// The TPU kernel keeps a [bq, 2F] block of u in VMEM; here one 64-row block
// of u at C = 1280 is 1.3 MB, far past a CTA's 227 KB of shared memory, and
// the one-kernel design (a) would recompute GEMM1 for every output-column
// tile (5 to 20 times). Writing h costs 2 * M * F * 2 bytes (0.1 ms at
// 3.35 TB/s at the largest shape) and keeps every flop computed once. The
// LayerNorm is not folded into GEMM1's operand loads: there every one of the
// F/64 column tiles of a row block recomputes the block's statistics in a
// latency-bound prologue and stages x through registers (that variant took
// 2.7 ms at B16 L4096 C320 on an H100 80GB HBM3 at 700 W, against 0.93 ms
// for the unfused torch chain). y is rounded to bf16 in the reference chain
// anyway, so writing it (2 * M * C * 2 bytes, 0.025 ms at that shape)
// changes no bit and leaves both GEMMs the same cp.async pipeline.
//
// Both GEMMs are mma.sync m16n8k16 bf16 with fp32 accumulators
// (flash_common.cuh's mma), operands loaded with ldmatrix: CTA tile 128 rows
// x 128 weight rows, 8 warps (4 along the rows x 2 along the columns, 32 x 64
// each), depth 64 per stage, a three-stage cp.async ring in dynamic shared
// memory, two CTAs per SM. B operands are nn.Linear weights as they lie,
// [out, in] row-major, whose 8x8 blocks ldmatrix hands over as mma B
// fragments without a transpose. GEMM1's 128 weight rows are the value and
// gate rows of 64 h columns, interleaved by 32, so that each thread holds a
// value and its gate in the same fragment slot; GEMM2's are 128 output
// columns, the last tile zero-filled past C (at C = 320 a fifth of GEMM2's
// products are wasted). Simple and right first: no wgmma or TMA.
//
// Build (nvcc -Xptxas=-v, sm_90a, CUDA 12.8): 126 registers for the GEMM1
// kernel, no spills; 128 for GEMM2 (the cap of two CTAs per SM) with an
// 8-byte spill; 86 for the LayerNorm; 108 KB of dynamic shared memory per
// GEMM CTA.

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::cp_async_16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::mma_16816;
using flash::pack_bf16x2;
using flash::smem_addr;

constexpr int BM = 128;        // rows per CTA
constexpr int BK = 64;         // depth per stage
constexpr int LDS = BK + 8;    // shared row stride: 144 bytes, conflict-free ldmatrix
constexpr int STAGES = 3;
constexpr int NTHREADS = 256;  // 8 warps: 4 along the rows x 2 along the columns
constexpr int WM = 32;         // rows per warp
constexpr int BN = 128;        // weight rows per CTA: the value and gate rows of 64 h
                               // columns in GEMM1, 128 output columns in GEMM2
constexpr int LN_THREADS = 256;
constexpr int LN_MAX_VECS = 8;  // 16-byte vectors of a row per lane: C <= 2048

enum { EPI_GEGLU = 0, EPI_RESIDUAL = 1 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// ---------------------------------------------------------------- LayerNorm
// y[row] = bf16((x - mu) * rstd * g + b), one warp per row, the row held in
// registers between the statistics and the normalisation.
__global__ void __launch_bounds__(LN_THREADS)
ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_g,
          const bf16* __restrict__ ln_b, bf16* __restrict__ y, int m, int c, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32;
  if (row >= m) return;
  const int nv = c / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * c);
  uint4 v[LN_MAX_VECS];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_VECS; ++i) {
    const int j = lane + 32 * i;
    if (j < nv) {
      v[i] = xr[j];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 q = __bfloat1622float2(p[e]);
        s += q.x + q.y;
        ss = fmaf(q.x, q.x, fmaf(q.y, q.y, ss));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / c;
  const float rstd = rsqrtf(fmaxf(ss / c - mu * mu, 0.f) + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * c);
#pragma unroll
  for (int i = 0; i < LN_MAX_VECS; ++i) {
    const int j = lane + 32 * i;
    if (j < nv) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
      uint4 out;
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 q = __bfloat1622float2(p[e]);
        const float2 gg = ld_bf16x2(ln_g + 8 * j + 2 * e);
        const float2 bb = ld_bf16x2(ln_b + 8 * j + 2 * e);
        o[e] = pack_bf16x2((q.x - mu) * rstd * gg.x + bb.x, (q.y - mu) * rstd * gg.y + bb.y);
      }
      yr[j] = out;
    }
  }
}

// ---------------------------------------------------------------- GEMMs
// EPI_GEGLU:    a = A [M, K = C] (y), w = w1t [2F, C]; writes h[:, n0 : n0 + 64]
//               (CTA weight row r: 32 value rows then 32 gate rows per warp
//               column; value column j pairs with gate column F + j).
// EPI_RESIDUAL: a = h [M, K = F], w = w2t [C, F]; writes out[:, n0 : n0 + 128]
//               = x + bf16(bf16(acc) + b2), columns below C only.
template <int EPI>
__global__ void __launch_bounds__(NTHREADS, 2)
gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
            const bf16* __restrict__ bias, const bf16* __restrict__ x,
            bf16* __restrict__ out, int m, int k, int ldo, int f) {
  constexpr int NI = BN / 16;                          // n-tiles per warp
  constexpr int OUT = EPI == EPI_GEGLU ? BN / 2 : BN;  // output columns per CTA
  extern __shared__ __align__(16) bf16 smem[];
  bf16 (*As)[BM][LDS] = reinterpret_cast<bf16 (*)[BM][LDS]>(smem);
  bf16 (*Bs)[BN][LDS] = reinterpret_cast<bf16 (*)[BN][LDS]>(smem + STAGES * BM * LDS);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4, wm = warp % 4, wn = warp / 4;
  const int n0 = blockIdx.x * OUT, m0 = blockIdx.y * BM;

  const auto w_row = [&](int r) {  // GEMM2 zero-fills its rows past C
    if constexpr (EPI == EPI_GEGLU) {
      const int col = n0 + (r / (BN / 2)) * (BN / 4) + r % (BN / 4);
      return col + ((r % (BN / 2)) / (BN / 4)) * f;
    }
    return n0 + r;
  };
  const auto load_stage = [&](int slot, int k0) {
#pragma unroll
    for (int i = tid; i < BM * (BK / 8); i += NTHREADS) {
      const int r = i / (BK / 8), cv = (i % (BK / 8)) * 8;
      const bool valid = m0 + r < m;
      cp_async_16(&As[slot][r][cv], valid ? a + (size_t)(m0 + r) * k + k0 + cv : a, valid);
    }
#pragma unroll
    for (int i = tid; i < BN * (BK / 8); i += NTHREADS) {
      const int r = i / (BK / 8), cv = (i % (BK / 8)) * 8;
      const bool valid = EPI == EPI_GEGLU || n0 + r < ldo;
      cp_async_16(&Bs[slot][r][cv], valid ? w + (size_t)w_row(r) * k + k0 + cv : w, valid);
    }
  };

  float acc[2][NI][4] = {};
  const int kt_n = k / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load_stage(s, s * BK);
    cp_async_commit();
  }
  // ldmatrix source rows: A x4 -> rows lane%16, k half lane/16; B x4 -> two
  // n-tiles (lane/16), k half (lane/8)%2, row lane%8
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = (lane / 16) * 8 + lane % 8, b_col = ((lane / 8) % 2) * 8;
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < kt_n) load_stage((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();
    const int slot = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], &As[slot][wm * WM + mi * 16 + a_row][kk + a_col]);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t bf[4];
        ldmatrix_x4(bf, &Bs[slot][wn * (BN / 2) + nj * 16 + b_row][kk + b_col]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_16816(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_16816(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * WM + mi * 16 + g + half * 8;
      if (row >= m) continue;
      if constexpr (EPI == EPI_GEGLU) {
        // value n-tile ni pairs with gate n-tile ni + NI / 2
#pragma unroll
        for (int ni = 0; ni < NI / 2; ++ni) {
          const int col = n0 + wn * (BN / 4) + ni * 8 + t * 2;
          const float2 ba = ld_bf16x2(bias + col), bg = ld_bf16x2(bias + f + col);
          const float* va = &acc[mi][ni][2 * half];
          const float* vg = &acc[mi][ni + NI / 2][2 * half];
          const float a0 = bf16_round(bf16_round(va[0]) + ba.x);
          const float a1 = bf16_round(bf16_round(va[1]) + ba.y);
          const float g0 = bf16_round(bf16_round(vg[0]) + bg.x);
          const float g1 = bf16_round(bf16_round(vg[1]) + bg.y);
          *reinterpret_cast<uint32_t*>(out + (size_t)row * ldo + col) =
              pack_bf16x2(a0 * bf16_round(gelu_tanh(g0)), a1 * bf16_round(gelu_tanh(g1)));
        }
      } else {
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int col = n0 + wn * (BN / 2) + ni * 8 + t * 2;
          if (col >= ldo) continue;
          const float2 bb = ld_bf16x2(bias + col), xx = ld_bf16x2(x + (size_t)row * ldo + col);
          const float o0 = bf16_round(bf16_round(acc[mi][ni][2 * half]) + bb.x);
          const float o1 = bf16_round(bf16_round(acc[mi][ni][2 * half + 1]) + bb.y);
          *reinterpret_cast<uint32_t*>(out + (size_t)row * ldo + col) =
              pack_bf16x2(xx.x + o0, xx.y + o1);
        }
      }
    }
  }
}

template <int EPI>
constexpr size_t gemm_smem() {
  return (size_t)STAGES * (BM + BN) * LDS * sizeof(bf16);
}

}  // namespace

// x, out: [m, c]; ln_g, ln_b, b2: [c]; w1t: [2f, c] (value rows, then gate
// rows); b1: [2f]; w2t: [c, f]; y: [m, c] and h: [m, f] scratch. All bf16,
// contiguous, 16-byte aligned; c and f multiples of 64, c <= 2048. Returns a
// cudaError_t (0 on success); launches only.
extern "C" int ln_geglu_ff_fwd(const void* x, const void* ln_g, const void* ln_b,
                               const void* w1t, const void* b1, const void* w2t,
                               const void* b2, void* y, void* h, void* out, int m, int c,
                               int f, float eps, void* stream) {
  const int row_blocks = (m + BM - 1) / BM;
  if (m <= 0 || c <= 0 || f <= 0 || c % 64 || f % 64 || c > 256 * LN_MAX_VECS ||
      row_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr1 = flash::allow_smem(gemm_kernel<EPI_GEGLU>,
                                                     gemm_smem<EPI_GEGLU>());
  static const cudaError_t attr2 = flash::allow_smem(gemm_kernel<EPI_RESIDUAL>,
                                                     gemm_smem<EPI_RESIDUAL>());
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr2 != cudaSuccess) return (int)attr2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  ln_kernel<<<(m + LN_THREADS / 32 - 1) / (LN_THREADS / 32), LN_THREADS, 0, s>>>(
      xb, static_cast<const bf16*>(ln_g), static_cast<const bf16*>(ln_b),
      static_cast<bf16*>(y), m, c, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gemm_kernel<EPI_GEGLU><<<dim3(f / (BN / 2), row_blocks), NTHREADS, gemm_smem<EPI_GEGLU>(),
                           s>>>(static_cast<const bf16*>(y), static_cast<const bf16*>(w1t),
                                static_cast<const bf16*>(b1), nullptr, static_cast<bf16*>(h),
                                m, c, f, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gemm_kernel<EPI_RESIDUAL><<<dim3((c + BN - 1) / BN, row_blocks), NTHREADS,
                              gemm_smem<EPI_RESIDUAL>(), s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2t),
      static_cast<const bf16*>(b2), xb, static_cast<bf16*>(out), m, f, c, f);
  return (int)cudaGetLastError();
}
