// K9: the UNet transformer block's feed-forward, fused: out = x +
// Linear(F -> C)(a * gelu_tanh(g)) with [a | g] = Linear(C -> 2F)(LayerNorm(x)),
// on bf16 [M, C] rows, for Hopper (sm_90a). Replaces the TPU kernel
// adaface_tpu/ops/fused_ff.py:_ff_kernel, with its roundings:
//   y = bf16((x - mu) * rsqrt(var + eps) * ln_g + ln_b), one-pass fp32 stats
//       (var = max(E[x^2] - mu^2, 0));
//   u = bf16(bf16(y . w1) + b1) (fp32 accumulation, bias after the cast);
//   h = bf16(a * bf16(gelu_tanh(g))) (the value half first, then the gate);
//   out = bf16(x + bf16(bf16(h . w2) + b2)).
//
// Bound: operations. 24 * M * C^2 flops at F = 4C (2*M*C*2F + 2*M*F*C) on
// the tensor cores at 989 TFLOP/s against x in, out and both weights once at
// 3.35 TB/s: at M = 16 * 4096, C = 320 that is 0.163 ms of flops against
// 0.027 ms of bytes.
//
// Three launches (four where GEMM2 is split), as the reference chain's
// roundings allow:
//   ln_kernel:                 y = LN(x) [M, C] bf16, 8-32 lanes a row;
//   gemm_kernel<EPI_GEGLU>:    h = GEGLU(y . w1 + b1) [M, F] bf16;
//   gemm_kernel<EPI_RESIDUAL>: out = x + (h . w2 + b2) [M, C], or, split
//                              along F, fp32 partials that splitk_reduce sums.
// The TPU kernel keeps a [bq, 2F] block of u in VMEM; here one 64-row block
// of u at C = 1280 is 1.3 MB, far past a CTA's 227 KB of shared memory, and
// one kernel would recompute GEMM1 for every output-column tile (5 to 20
// times). Writing h costs 2 * M * F * 2 bytes (0.1 ms at 3.35 TB/s at the
// largest shape), which the GEMMs' copies overlap with their products. The
// LayerNorm is not folded into GEMM1's operand loads: there every column
// tile of a row block recomputes the block's statistics (that variant took
// 2.7 ms at B16 L4096 C320 on an H100 80GB HBM3 at 700 W, against 0.93 ms
// for the unfused torch chain); y is rounded to bf16 in the reference chain
// anyway, so writing it changes no bit.
//
// Both GEMMs are "TN": A (y or h) [M, K] and B (the nn.Linear weight as it
// lies, [out, in]) are both K-major, so wgmma reads both from shared memory.
// One kernel template does both:
//   - a persistent grid (at most one CTA per SM) walks the work items (row
//     block, column block, K split) with a stride of the grid, in the order
//     of `gemm_items` in ops/fused_ff.py, whose `launch_plan` chooses the
//     tiles, GEMM2's split and the grids;
//   - one thread of warpgroup 2 keeps a ring of K steps of 64 columns in
//     flight (as many stages as shared memory holds, at most 6): per stage
//     one TMA copy of A and one (GEMM2) or two (GEMM1: the value rows j..
//     and the gate rows F + j.. of BN h columns, stacked into one B tile of
//     2 BN rows) of B, in the 128-byte-swizzled layout, with a full and an
//     empty mbarrier per stage. It runs on into the next item while the
//     consumers finish the last one;
//   - two consumer warpgroups own 64 rows each (GEMM2 at 256-row tiles: two
//     64-row slabs each, so a B tile serves twice the rows): four wgmma
//     m64nNk16 a stage and slab (N = 2 BN in GEMM1, BN in GEMM2), the stage
//     released once the next stage's products are issued
//     (wgmma.wait_group 1); setmaxnreg moves warpgroup 2's registers to
//     their accumulators;
//   - GEMM1's epilogue: the consumers round the accumulators to bf16 into a
//     shared u tile and go on to the next item; three epilogue warps (the
//     rest of warpgroup 2) add b1, apply GEGLU (value column c and its gate
//     column BN + c of the same row) and store h 16 bytes at a time, while
//     the consumers run the next item's products;
//   - GEMM2's tiles are BN = 160 columns where C allows (160 divides 320,
//     640 and 1280, so no product is wasted); its epilogue adds b2 and the
//     residual. Where the plan splits F (few rows), each split writes its
//     fp32 partial to a workspace and splitk_reduce sums the partials in
//     split order before the one bf16 rounding, so two launches agree bit
//     for bit (no float atomics).
// What was measured on the way (PERF.md, PR 7, with ff_variants.py): the
// copies and the products each alone take nearly the whole time, and
// overlap; at C320 (5 K steps an item) GEGLU's arithmetic paces GEMM1.
// Clusters multicasting B, the copies issued by a consumer thread, a
// quarter of GEGLU on the consumers, and more epilogue warps (512 threads
// leave wgmma m64n256 too few registers) were tried and taken out.

#include <type_traits>

#include "hopper_common.cuh"

namespace {

using flash::allow_smem;
using flash::bf16;
using flash::pack_bf16x2;
using namespace hopper;

constexpr int BM = 128;  // GEMM1's rows per tile: two consumer warpgroups of 64
constexpr int BK = 64;   // contraction columns per stage: one 128-byte row
constexpr int NCONS = 256;             // consumer threads: warpgroups 0 and 1
constexpr int NTHREADS = NCONS + 128;  // warpgroup 2: the producer warp, 3 epilogue warps
constexpr int NEPI = 96;               // GEMM1's epilogue threads (warps 9-11)
// Registers a thread, moved by setmaxnreg from warpgroup 2 to the
// consumers' accumulators. A launch of 384 threads starts at 168 each, and
// setmaxnreg.inc waits until the pool has what it asks for, so the sum
// stays at 384 * 168: 256 * 216 + 128 * 72.
constexpr int CONSUMER_REGS = 216;
constexpr int WG2_REGS = 72;
static_assert(2 * CONSUMER_REGS + WG2_REGS <= 3 * 168, "setmaxnreg would wait forever");
// Named barriers between GEMM1's consumers and its epilogue warps over the
// shared u tile (0 is __syncthreads): full after the consumers' writes,
// empty after the epilogue's reads.
constexpr int BAR_U_FULL = 1, BAR_U_EMPTY = 2;
constexpr int MAX_SMEM = 232448;  // a CTA's dynamic shared memory on sm_90
constexpr int LN_THREADS = 256;
constexpr int LN_MAX_VECS = 8;  // 16-byte vectors of a row per lane: C <= 2048
constexpr int RED_THREADS = 256;

enum { EPI_GEGLU = 0, EPI_RESIDUAL = 1 };

// BN: h columns per tile (GEGLU; the B tile holds their BN value rows then
// their BN gate rows) or output columns per tile (RESIDUAL). SLABS: 64-row
// slabs a consumer warpgroup, 1 or (GEMM2 only: GEMM1's accumulators have
// room for one) 2, so that one B tile serves 256 rows.
template <int EPI, int BN, int SLABS>
struct Gemm {
  static_assert(SLABS == 1 || (SLABS == 2 && EPI == EPI_RESIDUAL), "slabs");
  static constexpr int N = EPI == EPI_GEGLU ? 2 * BN : BN;  // wgmma N
  static constexpr int ROWS = 2 * 64 * SLABS;
  static constexpr int A_BYTES = ROWS * BK * 2;
  static constexpr int B_BYTES = N * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // a multiple of 1024
  // GEGLU: the tile's u = bf16(y . w1) [BM][N], value then gate columns,
  // rows padded by 16 bytes so that a warp's 4-byte accumulator writes (8
  // rows x 4 column pairs) hit 32 distinct banks
  static constexpr int U_ROW = N * 2 + 16;
  static constexpr int U_BYTES = EPI == EPI_GEGLU ? BM * U_ROW : 0;
  // as many stages as fit beside the u tile (the ring 1024-byte aligned at
  // run time, hence the slack; then the full and empty barriers), at most 6
  static constexpr int FIT = (MAX_SMEM - 1024 - 2 * 8 * 8 - U_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + U_BYTES + 2 * STAGES * 8;
  static_assert(STAGES >= 3, "too few stages");
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 0.5 v (1 + tanh(u)) written as v * sigmoid(2u): one ex2 and one
// reciprocal on the special-function unit instead of tanhf's ~30
// instructions, fp32 to a few ulps (the bf16 rounding after it is 2^-8).
__device__ __forceinline__ float gelu_tanh(float v) {
  const float u2 = 1.5957691216057308f * (v + 0.044715f * v * v * v);
  return __fdividef(v, 1.f + __expf(-u2));
}

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------- LayerNorm
// y[row] = bf16((x - mu) * rstd * g + b). A row is held by a group of G
// lanes (G = 8, 16 or 32 as C grows, at most LN_MAX_VECS 16-byte vectors a
// lane), in registers between the statistics and the normalisation; several
// rows a warp keep enough loads in flight at small C.
template <int G>
__global__ void __launch_bounds__(LN_THREADS)
ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_g,
          const bf16* __restrict__ ln_b, bf16* __restrict__ y, int m, int c, float eps) {
  const int lane = threadIdx.x % G;
  const int row = blockIdx.x * (LN_THREADS / G) + threadIdx.x / G;
  if (row >= m) return;  // whole groups leave together
  const int nv = c / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * c);
  uint4 v[LN_MAX_VECS];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_VECS; ++i) {
    const int j = lane + G * i;
    if (j < nv) v[i] = xr[j];
  }
#pragma unroll
  for (int i = 0; i < LN_MAX_VECS; ++i) {
    if (lane + G * i < nv) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 q = __bfloat1622float2(p[e]);
        s += q.x + q.y;
        ss = fmaf(q.x, q.x, fmaf(q.y, q.y, ss));
      }
    }
  }
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << G) - 1) << (threadIdx.x % 32 / G * G);
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    s += __shfl_xor_sync(mask, s, o);
    ss += __shfl_xor_sync(mask, ss, o);
  }
  const float mu = s / c;
  const float rstd = rsqrtf(fmaxf(ss / c - mu * mu, 0.f) + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * c);
#pragma unroll
  for (int i = 0; i < LN_MAX_VECS; ++i) {
    const int j = lane + G * i;
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

template <int G>
cudaError_t launch_ln(const bf16* x, const bf16* ln_g, const bf16* ln_b, bf16* y, int m, int c,
                      float eps, cudaStream_t s) {
  constexpr int rows = LN_THREADS / G;
  ln_kernel<G><<<(m + rows - 1) / rows, LN_THREADS, 0, s>>>(x, ln_g, ln_b, y, m, c, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- GEMMs
// Work item -> row block, column block and K-step range [k0, k1), in the
// order of ops/fused_ff.py:gemm_items: the split fastest, then the column
// block, then the row block.
struct Item {
  int mb, nb, s, k0, k1;
};

__device__ __forceinline__ Item decode(int item, int nblk, int split, int ksteps) {
  Item w;
  w.s = item % split;
  const int tile = item / split;
  w.nb = tile % nblk;
  w.mb = tile / nblk;
  w.k0 = w.s * ksteps / split;
  w.k1 = (w.s + 1) * ksteps / split;
  return w;
}

// The two consumer warpgroups: wgmma on each stage as it lands, then the
// item's epilogue. GEGLU: u = bf16(acc) to the shared u tile for the
// epilogue warps. RESIDUAL: out = x + bf16(bf16(acc) + b2), or the fp32
// partial when split.
template <int EPI, int BN, int SLABS>
__device__ __forceinline__ void consume(const unsigned char* ring, unsigned char* u_tile,
                                        uint64_t* full, uint64_t* empty,
                                        const bf16* __restrict__ bias,
                                        const bf16* __restrict__ x, bf16* __restrict__ out,
                                        float* __restrict__ ws, int m, int n, int k,
                                        int split) {
  using G = Gemm<EPI, BN, SLABS>;
  constexpr int N = G::N;
  constexpr int STAGES = G::STAGES;
  const int nblk = n / BN, ksteps = k / BK;
  const int items = (m + G::ROWS - 1) / G::ROWS * nblk * split;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's tile rows: r0 + 64 j and r0 + 64 j + 8 of slab j
  const int r0 = wg * 64 * SLABS + warp * 16 + g;
  float acc[SLABS][N / 2] = {};  // each item's first product overwrites it (scale_d 0)
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item w = decode(item, nblk, split, ksteps);
    const int row0 = w.mb * G::ROWS;
    for (int ks = w.k0; ks < w.k1; ++ks, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      __syncwarp();  // wgmma wants the warp converged
      const unsigned char* tile = ring + st * G::STAGE_BYTES;
      const uint64_t db = smem_desc_sw128(tile + G::A_BYTES);
#pragma unroll
      for (int j = 0; j < SLABS; ++j) fence_regs(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < SLABS; ++j) {
        const uint64_t da = smem_desc_sw128(tile + (wg * SLABS + j) * 64 * BK * 2);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<N>(acc[j], da + 2 * kk, db + 2 * kk, (ks > w.k0 || kk > 0) ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
#pragma unroll
      for (int j = 0; j < SLABS; ++j) fence_regs(acc[j]);
      if (ks > w.k0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < SLABS; ++j) fence_regs(acc[j]);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

    if constexpr (EPI == EPI_GEGLU) {
      bar_sync(BAR_U_EMPTY, NCONS + NEPI);  // the epilogue has read the last tile
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half;
          *reinterpret_cast<uint32_t*>(u_tile + r * G::U_ROW + 16 * i + 4 * t) =
              pack_bf16x2(acc[0][4 * i + 2 * half], acc[0][4 * i + 2 * half + 1]);
        }
      bar_arrive(BAR_U_FULL, NCONS + NEPI);
    } else {
#pragma unroll
      for (int j = 0; j < SLABS; ++j) {
        // the slab's x and b2 first, so that their loads are in flight together
        __nv_bfloat162 xs[BN / 4], bs[BN / 8];
        if (split == 1) {
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const int col = w.nb * BN + 8 * i + 2 * t;
            bs[i] = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = row0 + r0 + 64 * j + 8 * half;
              xs[2 * i + half] = row < m
                  ? *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * n + col)
                  : __floats2bfloat162_rn(0.f, 0.f);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = w.nb * BN + 8 * i + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = row0 + r0 + 64 * j + 8 * half;
            if (row >= m) continue;
            const float v0 = acc[j][4 * i + 2 * half], v1 = acc[j][4 * i + 2 * half + 1];
            if (split == 1) {  // bf16x2 adds: one rounding each, as the reference's
              const __nv_bfloat162 o = __hadd2(__floats2bfloat162_rn(v0, v1), bs[i]);
              *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + col) =
                  __hadd2(xs[2 * i + half], o);
            } else {
              *reinterpret_cast<float2*>(ws + ((size_t)w.s * m + row) * n + col) =
                  make_float2(v0, v1);
            }
          }
        }
      }
    }
  }
}

// GEMM1's epilogue warps (NEPI threads): for each item, wait for the u
// tile, then h = bf16(a * bf16(gelu_tanh(g))) with a = bf16(u_a + b1), g =
// bf16(u_g + b1), 8 h columns (one 16-byte store) of a row at a time. A
// thread keeps one 8-column chunk, so its 16 biases load once an item. The
// bias adds and the product are bf16x2 instructions: each rounds the exact
// result once, which is what the reference's fp32 add or product of two
// bf16 values (exact, or within 2^-16 of the larger one) followed by the
// cast gives.
template <int BN>
__device__ __forceinline__ void geglu_epilogue(const unsigned char* u_tile,
                                               const bf16* __restrict__ b1,
                                               bf16* __restrict__ h, int m, int f) {
  constexpr int U_ROW = Gemm<EPI_GEGLU, BN, 1>::U_ROW;
  constexpr int CHV = BN / 8;       // chunks of the value half of a u row
  constexpr int STEP = NEPI / CHV;  // rows apart of a thread's rows
  const int e = threadIdx.x - (NCONS + 32);
  const int c = e % CHV;
  const int nblk = f / BN;
  const int items = (m + BM - 1) / BM * nblk;
  bar_arrive(BAR_U_EMPTY, NCONS + NEPI);  // the tile starts free
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int nb = item % nblk, row0 = item / nblk * BM;
    const int col = nb * BN + 8 * c;
    const uint4 bav = *reinterpret_cast<const uint4*>(b1 + col);
    const uint4 bgv = *reinterpret_cast<const uint4*>(b1 + f + col);
    const __nv_bfloat162* ba = reinterpret_cast<const __nv_bfloat162*>(&bav);
    const __nv_bfloat162* bg = reinterpret_cast<const __nv_bfloat162*>(&bgv);
    bar_sync(BAR_U_FULL, NCONS + NEPI);
    if (e < STEP * CHV) {
#pragma unroll 2
      for (int r = e / CHV; r < BM; r += STEP) {
        const uint4 ua = *reinterpret_cast<const uint4*>(u_tile + r * U_ROW + 16 * c);
        const uint4 ug = *reinterpret_cast<const uint4*>(u_tile + r * U_ROW + 16 * (CHV + c));
        const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&ua);
        const __nv_bfloat162* pg = reinterpret_cast<const __nv_bfloat162*>(&ug);
        uint4 hv;
        __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(&hv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 g = __bfloat1622float2(__hadd2(pg[j], bg[j]));
          ph[j] = __hmul2(__hadd2(pa[j], ba[j]),
                          __floats2bfloat162_rn(gelu_tanh(g.x), gelu_tanh(g.y)));
        }
        if (row0 + r < m)
          *reinterpret_cast<uint4*>(h + (size_t)(row0 + r) * f + col) = hv;
      }
    }
    if (item + (int)gridDim.x < items) bar_arrive(BAR_U_EMPTY, NCONS + NEPI);
  }
}

// EPI_GEGLU:    A = y [M, K = C], B = w1t [2F, C]; n = F, h = out [M, F].
// EPI_RESIDUAL: A = h [M, K = F], B = w2t [C, F]; n = C; out [M, C] =
//               x + bf16(bf16(acc) + b2) when split == 1, else the fp32
//               partial of split s to ws[s] [M, C].
template <int EPI, int BN, int SLABS>
__global__ void __launch_bounds__(NTHREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const bf16* __restrict__ bias, const bf16* __restrict__ x,
            bf16* __restrict__ out, float* __restrict__ ws, int m, int n, int k, int split) {
  using G = Gemm<EPI, BN, SLABS>;
  constexpr int STAGES = G::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* u_tile = ring + STAGES * G::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(u_tile + G::U_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NCONS / 32);  // lane 0 of each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= NCONS) {  // warpgroup 2
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG2_REGS));
    if (tid == NCONS) {  // the producer: one thread issues every copy
      const int nblk = n / BN, ksteps = k / BK;
      const int items = (m + G::ROWS - 1) / G::ROWS * nblk * split;
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Item w = decode(item, nblk, split, ksteps);
        for (int ks = w.k0; ks < w.k1; ++ks, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[st], ((it / STAGES) + 1) & 1);
          mbar_arrive_expect_tx(&full[st], G::STAGE_BYTES);
          unsigned char* a_dst = ring + st * G::STAGE_BYTES;
          tma_load_2d(a_dst, &map_a, ks * BK, w.mb * G::ROWS, &full[st]);
          tma_load_2d(a_dst + G::A_BYTES, &map_b, ks * BK, w.nb * BN, &full[st]);
          if constexpr (EPI == EPI_GEGLU)  // the gate rows below the value rows
            tma_load_2d(a_dst + G::A_BYTES + BN * BK * 2, &map_b, ks * BK, n + w.nb * BN,
                        &full[st]);
        }
      }
    } else if constexpr (EPI == EPI_GEGLU) {
      if (tid >= NCONS + 32) geglu_epilogue<BN>(u_tile, bias, out, m, n);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<EPI, BN, SLABS>(ring, u_tile, full, empty, bias, x, out, ws, m, n, k, split);
  }
}

// out = bf16(x + bf16(bf16(sum_s ws[s]) + b2)), the partials summed in
// split order; 8 columns per thread.
__global__ void __launch_bounds__(RED_THREADS)
splitk_reduce(const float* __restrict__ ws, const bf16* __restrict__ b2,
              const bf16* __restrict__ x, bf16* __restrict__ out, int m, int n, int split) {
  const size_t v = (size_t)blockIdx.x * RED_THREADS + threadIdx.x;
  const size_t total = (size_t)m * n;
  if (v * 8 >= total) return;
  const size_t e0 = v * 8;
  const int col = (int)(e0 % n);
  float s[8];
  const float4* p = reinterpret_cast<const float4*>(ws + e0);
  float4 lo = p[0], hi = p[1];
  s[0] = lo.x, s[1] = lo.y, s[2] = lo.z, s[3] = lo.w;
  s[4] = hi.x, s[5] = hi.y, s[6] = hi.z, s[7] = hi.w;
  for (int sp = 1; sp < split; ++sp) {
    p = reinterpret_cast<const float4*>(ws + sp * total + e0);
    lo = p[0], hi = p[1];
    s[0] += lo.x, s[1] += lo.y, s[2] += lo.z, s[3] += lo.w;
    s[4] += hi.x, s[5] += hi.y, s[6] += hi.z, s[7] += hi.w;
  }
  const uint4 xv = *reinterpret_cast<const uint4*>(x + e0);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
  uint4 o;
  uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 xx = __bfloat1622float2(xp[e]);
    const float2 bb = ld_bf16x2(b2 + col + 2 * e);
    op[e] = pack_bf16x2(xx.x + bf16_round(bf16_round(s[2 * e]) + bb.x),
                        xx.y + bf16_round(bf16_round(s[2 * e + 1]) + bb.y));
  }
  *reinterpret_cast<uint4*>(out + e0) = o;
}

// One GEMM launch: A [m, k], B rows of `b_rows` x k, grid CTAs.
template <int EPI, int BN, int SLABS = 1>
int launch_gemm(const void* a, const void* b, int b_rows, const bf16* bias, const bf16* x,
                bf16* out, float* ws, int m, int n, int k, int split, int grid,
                cudaStream_t s) {
  using G = Gemm<EPI, BN, SLABS>;
  static const cudaError_t attr = allow_smem(gemm_kernel<EPI, BN, SLABS>, G::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map_a, map_b;
  if (make_sw128_map(&map_a, a, k, m, G::ROWS) != 0 ||
      make_sw128_map(&map_b, b, k, b_rows, EPI == EPI_GEGLU ? BN : G::N) != 0)
    return (int)cudaErrorInvalidValue;
  gemm_kernel<EPI, BN, SLABS><<<grid, NTHREADS, G::SMEM, s>>>(map_a, map_b, bias, x, out, ws, m, n,
                                                       k, split);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [m, c]; ln_g, ln_b, b2: [c]; w1t: [2f, c] (value rows, then gate
// rows); b1: [2f]; w2t: [c, f]; y: [m, c] and h: [m, f] scratch; ws: fp32
// [split, m, c] scratch (unused when split == 1). All bf16 but ws,
// contiguous, 16-byte aligned; c and f multiples of 64, c <= 2048. The plan
// (ops/fused_ff.py:launch_plan): bn1 h columns per GEMM1 tile (128 or 64,
// dividing f), bn2 output columns (160, 128 or 64, dividing c) and rows2
// rows (256 or 128) per GEMM2 tile, GEMM2's split of f (1..f/64), and each
// GEMM's persistent grid. Returns a cudaError_t (0 on success); launches
// only.
extern "C" int ln_geglu_ff_fwd(const void* x, const void* ln_g, const void* ln_b,
                               const void* w1t, const void* b1, const void* w2t,
                               const void* b2, void* y, void* h, void* ws, void* out, int m,
                               int c, int f, float eps, int bn1, int bn2, int rows2, int split,
                               int grid1, int grid2, void* stream) {
  if (m <= 0 || c <= 0 || f <= 0 || c % 64 || f % 64 || c > 256 * LN_MAX_VECS || bn1 <= 0 ||
      bn2 <= 0 || f % bn1 || c % bn2 || split < 1 || split > f / BK || (split > 1 && ws == nullptr) ||
      grid1 < 1 || grid2 < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  bf16* hb = static_cast<bf16*>(h);
  bf16* ob = static_cast<bf16*>(out);
  float* wsf = static_cast<float*>(ws);
  const bf16* g = static_cast<const bf16*>(ln_g);
  const bf16* bl = static_cast<const bf16*>(ln_b);
  const int nv = c / 8;  // 16-byte vectors a row
  const cudaError_t err = nv <= 8 * LN_MAX_VECS    ? launch_ln<8>(xb, g, bl, yb, m, c, eps, s)
                          : nv <= 16 * LN_MAX_VECS ? launch_ln<16>(xb, g, bl, yb, m, c, eps, s)
                                                   : launch_ln<32>(xb, g, bl, yb, m, c, eps, s);
  if (err != cudaSuccess) return (int)err;
  const bf16* bias1 = static_cast<const bf16*>(b1);
  int rc;
  switch (bn1) {
    case 128:
      rc = launch_gemm<EPI_GEGLU, 128>(y, w1t, 2 * f, bias1, nullptr, hb, nullptr, m, f, c, 1,
                                       grid1, s);
      break;
    case 64:
      rc = launch_gemm<EPI_GEGLU, 64>(y, w1t, 2 * f, bias1, nullptr, hb, nullptr, m, f, c, 1,
                                      grid1, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const bf16* bias2 = static_cast<const bf16*>(b2);
  const auto gemm2 = [&](auto bn, auto slabs) {
    return launch_gemm<EPI_RESIDUAL, decltype(bn)::value, decltype(slabs)::value>(
        h, w2t, c, bias2, xb, ob, wsf, m, c, f, split, grid2, s);
  };
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  if (rows2 == 256) {
    if (bn2 == 160) rc = gemm2(std::integral_constant<int, 160>(), Two());
    else if (bn2 == 128) rc = gemm2(std::integral_constant<int, 128>(), Two());
    else if (bn2 == 64) rc = gemm2(std::integral_constant<int, 64>(), Two());
    else return (int)cudaErrorInvalidValue;
  } else if (rows2 == 128) {
    if (bn2 == 160) rc = gemm2(std::integral_constant<int, 160>(), One());
    else if (bn2 == 128) rc = gemm2(std::integral_constant<int, 128>(), One());
    else if (bn2 == 64) rc = gemm2(std::integral_constant<int, 64>(), One());
    else return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || split == 1) return rc;
  const size_t vecs = (size_t)m * c / 8;
  splitk_reduce<<<(unsigned)((vecs + RED_THREADS - 1) / RED_THREADS), RED_THREADS, 0, s>>>(
      wsf, bias2, xb, ob, m, c, split);
  return (int)cudaGetLastError();
}
