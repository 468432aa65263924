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
// above x, out and both weights moved once (0.2 ms at 3.35 TB/s). So the
// GEMMs must keep the FFMA pipes busy: every other instruction, every
// shared-memory wait and every idle SM is time lost.
//
// Launches:
//   ff32_ln_kernel: y = LN(x) [M, C], a warp a row;
//   ff32_gemm_kernel<EPI_GEGLU>: h = GEGLU(y . w1 + b1) [M, F]; a tile's B
//     rows are 64 value rows (w1^T rows j..) and their 64 gate rows (F +
//     j..), so each thread holds a value column and its gate column;
//   ff32_gemm_kernel<EPI_RESIDUAL>: out = x + (h . w2 + b2) [M, C], or,
//     where the plan splits F, EPI_PARTIAL writes each F range's sum to ws
//     and ff32_split_sum_kernel adds x + ((p0 + p1) + ...) + b2, slices in
//     order.
// The plan (ops/fused_ff.py fp32_launch_plan) gives GEMM2's tile width
// (64, 128 or 160 columns: 160 divides the UNet's 320, 640 and 1280) and
// its split of F where the tiles would leave SMs idle. Tile t of a 1-D grid
// takes K range t % split, then column blocks fastest: the tiles in flight
// share their A rows (a row-fastest raster measured within 0.3% on an
// H100, PERF.md section 6).
//
// A GEMM tile: 128 rows by BN columns, 256 threads (8 warps, 4 x 2), each
// thread 8 rows (two runs of 4, 64 apart) by BN / 16 columns (runs of 4, 64
// apart, and a run of 2 at BN 160): an outer product per k, 2 float4 of A
// and 2-3 vectors of B from shared memory for 64-80 FFMA. Shared memory
// holds each stage of BK = 16 k transposed ([k][row], rows contiguous), so
// a warp's fragment reads are 64-128 contiguous bytes, in two buffers with
// one __syncthreads a stage; each k's fragments are loaded just before its
// FFMAs and ptxas schedules them among the unrolled stage's FFMAs (0.4-2.3%
// faster on an H100 than holding the next k's fragments in registers;
// PERF.md section 6). Device memory reaches the stages through a ring of
// RING slots of 16-byte
// cp.async copies, RING - 1 stages ahead; each thread copies 4 k of a row
// and, when they have landed, writes them transposed itself, so the ring
// needs no barrier and no register holds a stage in flight. GEMM1 and
// 64-column GEMM2 tiles are capped at 128 registers, two CTAs an SM. Each
// output sums its K products in order in one thread: two launches agree
// bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ffma_tile.cuh"  // cp_async16, cp_async_commit

namespace {

using ffma_tile::cp_async16;
using ffma_tile::cp_async_commit;

constexpr int NT = 256;            // threads a CTA: 8 warps
constexpr int BM = 128;            // rows a GEMM tile
constexpr int BK = 16;             // K columns a stage
constexpr int LDA = BM + 4;        // floats between the k rows of an A stage
constexpr int RING = 3;            // copy ring slots (RING - 1 stages in flight)
constexpr int H_COLS = 64;         // h columns a GEMM1 tile (its B tile: 2 x 64 rows)
constexpr int MAX_SPLIT = 8;
constexpr int LN_ROWS = NT / 32;   // rows a LayerNorm CTA: a warp each
constexpr int EPI_GEGLU = 0, EPI_RESIDUAL = 1, EPI_PARTIAL = 2;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = LN(x) * ln_g + ln_b per row; c a multiple of 4.
__global__ void __launch_bounds__(NT) ff32_ln_kernel(const float* __restrict__ x,
                                                     const float* __restrict__ ln_g,
                                                     const float* __restrict__ ln_b,
                                                     float* __restrict__ y, int m, int c,
                                                     float eps) {
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

struct GemmArgs {
  const float* a;     // [m, k], K contiguous
  const float* b;     // B rows [.., k], K contiguous (nn.Linear's weight)
  const float* bias;  // GEGLU: b1 [2f]; RESIDUAL: b2 [n]
  const float* x;     // RESIDUAL: the residual [m, n]
  float* out;         // GEGLU: h [m, f]; RESIDUAL: out [m, n]; PARTIAL: ws [split, m, n]
  int m, n, k;        // output rows and columns (GEGLU: h columns, f), K
  int nrow, ncol;     // row and column blocks
  int split;          // K ranges
};

template <int BN>
struct Tile {
  static constexpr int G4 = BN / 64;            // runs of 4 columns a thread
  static constexpr int R2 = BN % 64 / 32;       // and runs of 2 (BN 160: one)
  static constexpr int NJ = 4 * G4 + 2 * R2;    // columns a thread
  static constexpr int LDB = BN + 4;            // floats between the k rows of a B stage
  static constexpr int A4 = BM * BK / 4 / NT;   // float4 of A a thread copies a stage
  static constexpr int B4 = (BN * BK / 4 + NT - 1) / NT;  // of B (the last partly)
  static constexpr int RAW = (A4 + B4) * NT * 4;  // floats a slot of the copy ring
  // the copy ring, then the two transposed stages
  static constexpr size_t SMEM = (RING * RAW + 2 * BK * (LDA + LDB)) * sizeof(float);
  static_assert(BN % 32 == 0 && (BN % 64 == 0 || BN % 64 == 32), "BN: 64, 128 or 160");
  static_assert(BM * BK / 4 % NT == 0, "A's stage in whole float4 a thread");
};

// All but this thread's newest RING - 2 groups of copies have landed.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
}

// Two CTAs an SM (at most 128 registers a thread) for GEMM1 and 64-column
// GEMM2 tiles; 128 and 160 columns of GEMM2 take what they need (128
// columns spilled under the cap).
template <int EPI, int BN>
__global__ void __launch_bounds__(NT, EPI == EPI_GEGLU || BN == 64 ? 2 : 1)
    ff32_gemm_kernel(GemmArgs p) {
  using T = Tile<BN>;
  constexpr int NJ = T::NJ, LDB = T::LDB;
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);  // [RING][RAW]
  float* sa = raw + RING * T::RAW;               // [2][BK][LDA]
  float* sb = sa + 2 * BK * LDA;                 // [2][BK][LDB]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = warp / 2 * 4 + lane / 8;  // rows 4 tm .. + 3 and 64 + 4 tm .. + 3
  const int tn = warp % 2 * 8 + lane % 8;  // columns 4 tn .. + 3 (+ 64 g), 128 + 2 tn, + 1
  // tile blockIdx.x: K range s fastest, then column block nb, row block mb
  const int s = blockIdx.x % p.split, nb = blockIdx.x / p.split % p.ncol;
  const int m0 = blockIdx.x / p.split / p.ncol * BM;
  const int n0 = nb * (EPI == EPI_GEGLU ? H_COLS : BN);
  const int ksteps = p.k / BK;
  const int kt0 = s * ksteps / p.split, kt1 = (s + 1) * ksteps / p.split;

  // Copy i of a stage (idx = tid + i NT) is 4 k columns, 4 (idx % (BK /
  // 4)) .., of row idx / (BK / 4): of A for i < A4, then of B. A thread
  // copies its own into the ring slot at float4 idx (A) or A4 NT + idx (B)
  // and reads back only those, so the ring needs no barrier.
  auto issue = [&](int kt, int slot) {
    float* r = raw + slot * T::RAW;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < T::A4; ++i) {
      const int idx = threadIdx.x + i * NT, row = m0 + idx / (BK / 4);
      const bool valid = row < p.m;
      cp_async16(r + 4 * idx, p.a + (long long)(valid ? row : 0) * p.k + k0 + 4 * (idx % (BK / 4)),
                 valid);
    }
#pragma unroll
    for (int i = 0; i < T::B4; ++i) {
      const int idx = threadIdx.x + i * NT, br = idx / (BK / 4);
      // GEGLU: rows [0, 64) value rows n0.., [64, 128) gate rows n + n0..
      const int brow = EPI == EPI_GEGLU ? (br < H_COLS ? n0 + br : p.n + n0 + br - H_COLS)
                                        : n0 + br;
      if (idx < BN * BK / 4)
        cp_async16(r + 4 * (T::A4 * NT + idx),
                   p.b + (long long)brow * p.k + k0 + 4 * (idx % (BK / 4)), true);
    }
  };
  // this thread's landed copies in ring slot `slot` into stage buffer
  // `buf`, transposed: [k][row]
  auto transpose = [&](int slot, int buf) {
    const float* r = raw + slot * T::RAW;
    float* da = sa + buf * BK * LDA;
    float* db = sb + buf * BK * LDB;
#pragma unroll
    for (int i = 0; i < T::A4; ++i) {
      const int idx = threadIdx.x + i * NT, row = idx / (BK / 4), k = 4 * (idx % (BK / 4));
      const float4 v = *reinterpret_cast<const float4*>(r + 4 * idx);
      da[k * LDA + row] = v.x;
      da[(k + 1) * LDA + row] = v.y;
      da[(k + 2) * LDA + row] = v.z;
      da[(k + 3) * LDA + row] = v.w;
    }
#pragma unroll
    for (int i = 0; i < T::B4; ++i) {
      const int idx = threadIdx.x + i * NT, row = idx / (BK / 4), k = 4 * (idx % (BK / 4));
      if (idx < BN * BK / 4) {
        const float4 v = *reinterpret_cast<const float4*>(r + 4 * (T::A4 * NT + idx));
        db[k * LDB + row] = v.x;
        db[(k + 1) * LDB + row] = v.y;
        db[(k + 2) * LDB + row] = v.z;
        db[(k + 3) * LDB + row] = v.w;
      }
    }
  };

  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  // Fragments: A's 8 values of one k and B's of one k, loaded just before
  // its FFMAs.
  float fa[8], fb[NJ];
  auto frag_a = [&](const float* da, int kk, int half) {
    const float4 v = *reinterpret_cast<const float4*>(da + kk * LDA + 64 * half + 4 * tm);
    fa[4 * half] = v.x, fa[4 * half + 1] = v.y, fa[4 * half + 2] = v.z, fa[4 * half + 3] = v.w;
  };
  auto frag_b = [&](const float* db, int kk) {
#pragma unroll
    for (int g = 0; g < T::G4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(db + kk * LDB + 64 * g + 4 * tn);
      fb[4 * g] = v.x, fb[4 * g + 1] = v.y, fb[4 * g + 2] = v.z, fb[4 * g + 3] = v.w;
    }
    if constexpr (T::R2 > 0) {
      fb[4 * T::G4] = db[kk * LDB + 64 * T::G4 + 2 * tn];
      fb[4 * T::G4 + 1] = db[kk * LDB + 64 * T::G4 + 2 * tn + 1];
    }
  };

  // the ring: stage st of the tile's range in slot st % RING, copies of
  // RING - 1 stages in flight; stage st's transposed buffer is st % 2
#pragma unroll
  for (int st = 0; st + 1 < RING; ++st) {
    if (kt0 + st < kt1) issue(kt0 + st, st);
    cp_async_commit();
  }
  cp_async_wait_ring();
  transpose(0, 0);
  __syncthreads();
  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = kt - kt0, cur = st & 1;
    const float* da = sa + cur * BK * LDA;
    const float* db = sb + cur * BK * LDB;
    if (kt + RING - 1 < kt1) issue(kt + RING - 1, (st + RING - 1) % RING);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      frag_a(da, kk, 0), frag_a(da, kk, 1);
      frag_b(db, kk);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
    }
    if (kt + 1 < kt1) {
      // stage st + 1's copies have landed; the other buffer was last read
      // before the previous stage's barrier
      cp_async_wait_ring();
      transpose((st + 1) % RING, cur ^ 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + (i < 4 ? 4 * tm + i : 64 + 4 * tm + i - 4);
    if (row >= p.m) continue;
    if constexpr (EPI == EPI_GEGLU) {
      // columns 4 tn .. + 3 are h columns n0 + 4 tn ..; 64 + 4 tn .. their gates
      const int col = n0 + 4 * tn;
      const float4 bv = *reinterpret_cast<const float4*>(p.bias + col);
      const float4 bg = *reinterpret_cast<const float4*>(p.bias + p.n + col);
      *reinterpret_cast<float4*>(p.out + row * p.n + col) = make_float4(
          (acc[i][0] + bv.x) * gelu_tanh(acc[i][4] + bg.x),
          (acc[i][1] + bv.y) * gelu_tanh(acc[i][5] + bg.y),
          (acc[i][2] + bv.z) * gelu_tanh(acc[i][6] + bg.z),
          (acc[i][3] + bv.w) * gelu_tanh(acc[i][7] + bg.w));
    } else {
      float* o = p.out + (EPI == EPI_PARTIAL ? (long long)s * p.m * p.n : 0) + row * p.n;
#pragma unroll
      for (int g = 0; g < T::G4; ++g) {
        const int col = n0 + 64 * g + 4 * tn;
        float4 v = make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                               acc[i][4 * g + 3]);
        if constexpr (EPI == EPI_RESIDUAL) {
          const float4 xv = *reinterpret_cast<const float4*>(p.x + row * p.n + col);
          const float4 bv = *reinterpret_cast<const float4*>(p.bias + col);
          v = make_float4(xv.x + (v.x + bv.x), xv.y + (v.y + bv.y), xv.z + (v.z + bv.z),
                          xv.w + (v.w + bv.w));
        }
        *reinterpret_cast<float4*>(o + col) = v;
      }
      if constexpr (T::R2 > 0) {
        const int col = n0 + 64 * T::G4 + 2 * tn;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[i][4 * T::G4 + e];
          if constexpr (EPI == EPI_RESIDUAL) v = p.x[row * p.n + col + e] + (v + p.bias[col + e]);
          o[col + e] = v;
        }
      }
    }
  }
}

// out = x + (((ws[0] + ws[1]) + ...) + b2), elementwise over [m, n], the
// slices in order; n a multiple of 4.
__global__ void __launch_bounds__(NT)
    ff32_split_sum_kernel(const float* __restrict__ ws, const float* __restrict__ x,
                          const float* __restrict__ bias, float* __restrict__ out,
                          long long total, int n, int split) {
  const long long i = 4 * ((long long)blockIdx.x * NT + threadIdx.x);
  if (i >= total) return;
  float4 v = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < split; ++s) {
    const float4 w = *reinterpret_cast<const float4*>(ws + s * total + i);
    v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
  }
  const float4 xv = *reinterpret_cast<const float4*>(x + i);
  const float4 bv = *reinterpret_cast<const float4*>(bias + i % n);
  *reinterpret_cast<float4*>(out + i) = make_float4(
      xv.x + (v.x + bv.x), xv.y + (v.y + bv.y), xv.z + (v.z + bv.z), xv.w + (v.w + bv.w));
}

template <int EPI, int BN>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t s) {
  constexpr size_t smem = Tile<BN>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ff32_gemm_kernel<EPI, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ff32_gemm_kernel<EPI, BN><<<p.nrow * p.ncol * p.split, NT, smem, s>>>(p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_gemm2(const GemmArgs& p, cudaStream_t s) {
  return p.split > 1 ? launch_gemm<EPI_PARTIAL, BN>(p, s) : launch_gemm<EPI_RESIDUAL, BN>(p, s);
}

}  // namespace

// x, out: [m, c] fp32; ln_g, ln_b, b2: [c]; w1t: [2f, c] (nn.Linear's
// weight: value rows, then gate rows); b1: [2f]; w2t: [c, f]; y: [m, c] and
// h: [m, f] fp32 scratch; ws: [split, m, c] fp32 scratch where split > 1
// (else unused). All contiguous and 16-byte aligned; c and f multiples of
// 64. The plan (ops/fused_ff.py fp32_launch_plan): bn2 GEMM2's columns a
// tile (64, 128 or 160, dividing c), split its ranges of F (1..8, at most
// f / 16).
// Returns a cudaError_t (0 on success); launches only.
extern "C" int ln_geglu_ff_fp32_fwd(const void* x, const void* ln_g, const void* ln_b,
                                    const void* w1t, const void* b1, const void* w2t,
                                    const void* b2, void* y, void* h, void* ws, void* out, int m,
                                    int c, int f, float eps, int bn2, int split,
                                    void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(ln_g) |
                          reinterpret_cast<uintptr_t>(ln_b) | reinterpret_cast<uintptr_t>(w1t) |
                          reinterpret_cast<uintptr_t>(b1) | reinterpret_cast<uintptr_t>(w2t) |
                          reinterpret_cast<uintptr_t>(b2) | reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(ws) |
                          reinterpret_cast<uintptr_t>(out);
  const int nrow = (m + BM - 1) / BM;
  if (m <= 0 || c <= 0 || f <= 0 || c % 64 || f % 64 || (align & 15) ||
      (bn2 != 64 && bn2 != 128 && bn2 != 160) || c % bn2 || split < 1 || split > MAX_SPLIT ||
      split > f / BK || (split > 1 && ws == nullptr) ||
      (long long)nrow * (f / H_COLS) >= (1LL << 31) ||
      (long long)nrow * (c / bn2) * split >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  ff32_ln_kernel<<<(m + LN_ROWS - 1) / LN_ROWS, NT, 0, s>>>(
      xf, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), yf, m, c, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const GemmArgs g1{yf, static_cast<const float*>(w1t), static_cast<const float*>(b1), nullptr,
                    hf, m, f, c, nrow, f / H_COLS, 1};
  err = launch_gemm<EPI_GEGLU, 2 * H_COLS>(g1, s);
  if (err != cudaSuccess) return (int)err;
  float* o = static_cast<float*>(out);
  const float* bias2 = static_cast<const float*>(b2);
  const GemmArgs g2{hf, static_cast<const float*>(w2t), bias2, xf,
                    split > 1 ? static_cast<float*>(ws) : o, m, c, f, nrow, c / bn2, split};
  err = bn2 == 64 ? launch_gemm2<64>(g2, s) : bn2 == 128 ? launch_gemm2<128>(g2, s)
                                                         : launch_gemm2<160>(g2, s);
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long total = (long long)m * c;
  ff32_split_sum_kernel<<<(int)((total / 4 + NT - 1) / NT), NT, 0, s>>>(
      static_cast<const float*>(ws), xf, bias2, o, total, c, split);
  return (int)cudaGetLastError();
}
