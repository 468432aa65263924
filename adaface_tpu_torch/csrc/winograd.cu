// Winograd F(2x2, 3x3) stride-1 SAME 3x3 convolution + bias for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel of the JAX package
//   K10 adaface_tpu/ops/winograd.py:81  _wino_kernel
// reached through winograd_conv3x3 / conv3x3_same under ADAFACE_WINOGRAD.
//
// Function, NHWC x [B, H, W, Cin] bf16 (H, W even), transformed weights
// U_ij = (G g G^T)_ij bf16 (made by the caller), bias [Cout] bf16. For each
// 2x2 output tile (b, r, s), whose 4x4 input tile d starts at row 2r - 1,
// column 2s - 1 (SAME padding, rows and columns outside the image read as
// zeros):
//   t_ij = sum_pq BT[i][p] BT[j][q] d[p][q]   (16 positions; each +-d term
//          added in bf16 and rounded after every add, p outer, q inner, as
//          XLA rounds the TPU kernel's bf16 adds)
//   m_ij = t_ij[Cin] . U_ij[Cin, Cout]         (fp32 accumulation)
//   y_ac = sum_ij AT[a][i] AT[c][j] m_ij       (fp32), out[2r+a, 2s+c] =
//          bf16(y_ac + bias)
//
// What bounds it on an H100: the 16 products are 2*16*(B*H*W/4)*Cin*Cout =
// 8*B*H*W*Cin*Cout tensor-core flops, against 18*B*H*W*Cin*Cout for the
// direct conv; at the UNet's widths that is above the bytes of x, U and y
// moved once. But the products are 16 GEMMs of depth Cin whose output tile
// is held through all 16 positions (the four fp32 quadrants y_ac), so a
// CTA's tile is 128 tile rows x 64 columns, and the operands stream from L2
// at 2 * (128 + 64) bytes per 128 * 64 multiply-adds. Measured on an H100
// 80GB HBM3 at 700 W (wino_variants.py; PERF.md section 6) at B16 64x64
// C320: the copies alone take 0.19 ms (~6.7 TB/s of L2 reads), the products
// alone 0.16 ms (wgmma m64n64k16 reads 4 KB of shared memory per 32 clocks
// of math, two accumulator chains an SM), both together 0.20 ms; the
// transform 0.07 ms.
// Two launches (three when split):
//   (a) input transform: a thread takes 8 channels of one tile: 16-byte
//       loads (the 2x2 overlap of neighbouring tiles is read again, from
//       L1 or L2: threads that walked 2, 4 or 8 tiles along W, keeping the
//       shared columns in registers, measured 1-12% slower), t_ij in bf16x2
//       adds (one rounding each, which is the fp32 add's rounding to bf16
//       of two bf16 values), 16-byte stores to V [16][tiles][Cin_p] bf16
//       (channels zero-padded to Cin_p, a multiple of 64). V is 4x the
//       input's bytes, the price of not fusing (a) into (b).
//   (b) the 16 products: one CTA per work item (128 tile rows, 64 output
//       columns, a range of the flat (position, 64-channel K chunk)
//       sequence) in the order of ops/winograd.py:plan_items, whose
//       launch_plan picks the split of that sequence and which of rows or
//       columns runs fastest. One producer thread keeps a ring of STAGES
//       TMA copies in flight (V [128, 64] and U^T [64, 64] boxes,
//       128-byte-swizzled, U laid out [16][Cout_p][Cin_p], K-major); two
//       consumer warpgroups of 64 tile rows run wgmma m64n64k16 into the
//       position's m_ij (32 fp32 registers a thread), then add it with its
//       A^T signs into the four output quadrants, which stay on chip
//       through the item (three in 96 registers, one in shared memory).
//       Unsplit, the epilogue adds the bias in fp32, casts once and writes
//       depth-to-space straight into NHWC; split, each slice writes its
//       fp32 quadrants to a workspace and
//   (c) wino_split_sum sums the slices in slice order (no atomics, so two
//       launches agree bit for bit), adds the bias, casts and writes NHWC.

#include "hopper_common.cuh"

namespace {

using flash::allow_smem;
using flash::bf16;
using flash::pack_bf16x2;
using namespace hopper;

constexpr int BM = 128;                // tile rows a CTA: two consumer warpgroups of 64
constexpr int BN = 64;                 // output columns a CTA
constexpr int BK = 64;                 // channels a stage: one 128-byte swizzled row
constexpr int NCONS = 256;             // consumer threads: warpgroups 0 and 1
constexpr int NTHREADS = NCONS + 128;  // warpgroup 2: the producer thread
// ptxas holds every thread of a 384-thread launch to 168 registers (three
// warps share an SM sub-partition's 16 K), setmaxnreg or not; moving
// warpgroup 2's registers to the consumers at run time all the same
// measured 5-9% faster (PERF.md section 6). setmaxnreg.inc waits until the
// pool has what it asks for, so the sum stays at 384 * 168.
constexpr int CONSUMER_REGS = 224;
constexpr int PRODUCER_REGS = 56;
static_assert(2 * CONSUMER_REGS + PRODUCER_REGS <= 3 * 168, "setmaxnreg would wait forever");
constexpr int STAGES = 8;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // a multiple of 1024
// Quadrant 3 (a = c = 1) accumulates in shared memory, [BN / 2][NCONS]
// floats (a thread's values NCONS apart: conflict-free): with all four in
// registers (160 accumulators with m_ij) ptxas, held to 168 registers,
// waits out each wgmma before it moves their registers.
constexpr int YS_BYTES = BN / 2 * NCONS * 4;
constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + YS_BYTES + 2 * STAGES * 8;
static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
constexpr int TRANSFORM_THREADS = 256;
constexpr int SUM_THREADS = 256;

// BT[i][p] of F(2x2, 3x3): rows (1,0,-1,0), (0,1,1,0), (0,-1,1,0), (0,1,0,-1)
__host__ __device__ constexpr int bt(int i, int p) {
  return i == 0 ? (p == 0 ? 1 : p == 2 ? -1 : 0)
       : i == 1 ? (p == 1 || p == 2 ? 1 : 0)
       : i == 2 ? (p == 1 ? -1 : p == 2 ? 1 : 0)
                : (p == 1 ? 1 : p == 3 ? -1 : 0);
}

// AT[a][i]: rows (1,1,1,0), (0,1,-1,-1)
__host__ __device__ constexpr int at(int a, int i) {
  return a == 0 ? (i < 3 ? 1 : 0) : (i == 0 ? 0 : i == 1 ? 1 : -1);
}

// ---------------------------------------------------------------- (a) transform
// 8 bf16 of one input pixel's channels [c0, c0 + 8), zeros outside the image
// or past Cin. VEC: Cin % 8 == 0 and x 16-byte aligned, one 16-byte load.
template <bool VEC>
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ x, long long b, int row,
                                       int col, int c0, int H, int W, int Cin) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (row < 0 || row >= H || col < 0 || col >= W || c0 >= Cin) return v;
  const bf16* p = x + ((b * H + row) * W + col) * Cin + c0;
  if constexpr (VEC) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = c0 + k < Cin ? p[k] : __float2bfloat16_rn(0.0f);
  }
  return v;
}

__device__ __forceinline__ uint4 add8(uint4 a, uint4 b, bool sub) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 o;
  __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int k = 0; k < 4; ++k) po[k] = sub ? __hsub2(pa[k], pb[k]) : __hadd2(pa[k], pb[k]);
  return o;
}

__device__ __forceinline__ uint4 neg8(uint4 a) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  uint4 o;
  __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int k = 0; k < 4; ++k) po[k] = __hneg2(pa[k]);
  return o;
}

// One thread: channels [c0, c0 + 8) of tile m = (b, r, s).
template <bool VEC>
__global__ void __launch_bounds__(TRANSFORM_THREADS)
wino_input_kernel(const bf16* __restrict__ x, bf16* __restrict__ v, int H, int W, int Cin,
                  int Cin_p, long long M) {
  const int groups = Cin_p / 8;
  const int hh = H / 2, wh = W / 2;
  const long long idx = (long long)blockIdx.x * TRANSFORM_THREADS + threadIdx.x;
  if (idx >= M * groups) return;
  const int c0 = 8 * (int)(idx % groups);
  const long long m = idx / groups;
  const int s = (int)(m % wh);
  const int r = (int)((m / wh) % hh);
  const long long b = m / ((long long)wh * hh);

  uint4 d[4][4];  // input rows 2r - 1 + p, columns 2s - 1 + q
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) d[p][q] = load8<VEC>(x, b, 2 * r + p - 1, 2 * s + q - 1, c0, H, W, Cin);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint4 t = make_uint4(0, 0, 0, 0);
      bool first = true;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int sign = bt(i, p) * bt(j, q);
          if (sign == 0) continue;
          t = first ? (sign > 0 ? d[p][q] : neg8(d[p][q])) : add8(t, d[p][q], sign < 0);
          first = false;
        }
      }
      *reinterpret_cast<uint4*>(v + ((long long)(4 * i + j) * M + m) * Cin_p + c0) = t;
    }
  }
}

// ---------------------------------------------------------------- (b) products
// Work item -> row block, column block and flat step range [k0, k1) of the
// 16 * nk (position, K chunk) steps, in the order of ops/winograd.py:
// plan_items: the split slowest; then the row block fastest (m_fastest) or
// the column block fastest.
struct Item {
  int mb, nb, s, k0, k1;
};

__device__ __forceinline__ Item decode(int item, int mblk, int nblk, int split, int steps,
                                       int m_fastest) {
  Item w;
  const int tiles = mblk * nblk;
  w.s = item / tiles;
  const int tile = item % tiles;
  if (m_fastest) {
    w.mb = tile % mblk;
    w.nb = tile / mblk;
  } else {
    w.nb = tile % nblk;
    w.mb = tile / nblk;
  }
  w.k0 = w.s * steps / split;
  w.k1 = (w.s + 1) * steps / split;
  return w;
}

// y[q] += coef(q) * m for the position ij's A^T signs (q = 2a + c);
// quadrant 3 is the thread's column ys[e * NCONS] of shared memory.
__device__ __forceinline__ void add_position(float (&y)[3][BN / 2], float* ys,
                                             const float (&m)[BN / 2], int ij) {
  const int i = ij >> 2, j = ij & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int coef = at(q >> 1, i) * at(q & 1, j);
    if (coef == 0) continue;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      if (q < 3) {
        float& acc = y[q < 3 ? q : 0][e];
        acc = coef > 0 ? acc + m[e] : acc - m[e];
      } else {
        ys[e * NCONS] = coef > 0 ? ys[e * NCONS] + m[e] : ys[e * NCONS] - m[e];
      }
    }
  }
}

// Value e of quadrant q (q and e known at compile time).
__device__ __forceinline__ float quad(const float (&y)[3][BN / 2], const float* ys, int q, int e) {
  return q < 3 ? y[q < 3 ? q : 0][e] : ys[e * NCONS];
}

// The producer thread: the copies of the item's ring step it (product step
// w.k0 + it) into its stage, once both warpgroups have released its last use.
__device__ __forceinline__ void produce(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* map_v, const CUtensorMap* map_u,
                                        const Item& w, int nk, int Cout_p, long long M) {
  for (int it = 0; it < w.k1 - w.k0; ++it) {
    const int stage = it % STAGES;
    if (it >= STAGES) mbar_wait(&empty[stage], ((it / STAGES) + 1) & 1);
    mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
    unsigned char* dst = ring + stage * STAGE_BYTES;
    const int st = w.k0 + it;
    const int ij = st / nk, kc = st % nk;
    tma_load_2d(dst, map_v, kc * BK, (int)(ij * M + (long long)w.mb * BM), &full[stage]);
    tma_load_2d(dst + A_BYTES, map_u, kc * BK, ij * Cout_p + w.nb * BN, &full[stage]);
  }
}

// The two consumer warpgroups: wgmma on each stage as it lands into m_ij,
// m_ij into the quadrants at the end of each position (or of the item), then
// the epilogue.
__device__ __forceinline__ void consume(const unsigned char* ring, float* ys, uint64_t* full,
                                        uint64_t* empty, const Item& w, int nk,
                                        const bf16* __restrict__ bias, bf16* __restrict__ out,
                                        float* __restrict__ ws, int H, int W, int Cout,
                                        int Cout_p, long long M, int split) {
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float y[3][BN / 2] = {};
  float m[BN / 2] = {};
  ys += tid;
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) ys[e * NCONS] = 0.0f;
  // one position's run of steps at a time (a split may cut the first and the
  // last): products into m_ij, wgmma_wait<1> releasing the step before,
  // then wgmma_wait<0> and the adds
  for (int st = w.k0, it = 0; st < w.k1;) {
    const int ij = st / nk;
    const int end = min(w.k1, (ij + 1) * nk);
    for (int s = st; s < end; ++s, ++it) {
      const int stage = it % STAGES;
      mbar_wait(&full[stage], (it / STAGES) & 1);
      __syncwarp();  // wgmma wants the warp converged
      const unsigned char* tile = ring + stage * STAGE_BYTES;
      const uint64_t da = smem_desc_sw128(tile + wg * 64 * BK * 2);
      const uint64_t db = smem_desc_sw128(tile + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<BN>(m, da + 2 * kk, db + 2 * kk, (kk > 0 || s > st) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: release its stage
      if (lane == 0 && s > st) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(m);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    add_position(y, ys, m, ij);
    st = end;
  }

  // thread's rows r0 and r0 + 8 of the tile, columns 8 i + 2 t (+1)
  const int r0 = wg * 64 + warp * 16 + g;
  const int hh = H / 2, wh = W / 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = (long long)w.mb * BM + r0 + 8 * half;
    if (row >= M) continue;
    if (split > 1) {  // the slice's fp32 quadrants: ws [split][4][M][Cout_p]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float* dst = ws + (((long long)w.s * 4 + q) * M + row) * Cout_p + w.nb * BN + 2 * t;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
          *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(
              quad(y, ys, q, 4 * i + 2 * half), quad(y, ys, q, 4 * i + 2 * half + 1));
      }
      continue;
    }
    const int s = (int)(row % wh);
    const int r = (int)((row / wh) % hh);
    const long long b = row / ((long long)wh * hh);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = w.nb * BN + 8 * i + 2 * t;
      if (col >= Cout) continue;
      const bool two = col + 1 < Cout;
      const float b0 = __bfloat162float(bias[col]);
      const float b1 = two ? __bfloat162float(bias[col + 1]) : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bf16* dst = out + ((b * H + 2 * r + (q >> 1)) * W + 2 * s + (q & 1)) * Cout + col;
        const float v0 = quad(y, ys, q, 4 * i + 2 * half) + b0;
        const float v1 = quad(y, ys, q, 4 * i + 2 * half + 1) + b1;
        if (two && (Cout & 1) == 0) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (two) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// map_v: V as [16 * M rows, Cin_p], boxes of 64 channels x BM rows; map_u:
// U as [16 * Cout_p rows, Cin_p], boxes of 64 channels x BN rows.
__global__ void __launch_bounds__(NTHREADS, 1)
wino_product_kernel(const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_u, const bf16* __restrict__ bias,
                    bf16* __restrict__ out, float* __restrict__ ws, int H, int W, int Cout,
                    int Cout_p, long long M, int nk, int split, int m_fastest) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* ys = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES + YS_BYTES);
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

  const int mblk = (int)((M + BM - 1) / BM), nblk = Cout_p / BN;
  const Item w = decode(blockIdx.x, mblk, nblk, split, 16 * nk, m_fastest);
  if (tid >= NCONS) {  // warpgroup 2
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == NCONS) produce(ring, full, empty, &map_v, &map_u, w, nk, Cout_p, M);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume(ring, ys, full, empty, w, nk, bias, out, ws, H, W, Cout, Cout_p, M, split);
  }
}

// ---------------------------------------------------------------- (c) split sum
// out[b, 2r + a, 2s + c, col .. col + 3] = bf16(sum_s ws[s][2a + c][m][col ..]
// + bias), slices summed in order; 4 columns a thread.
__global__ void __launch_bounds__(SUM_THREADS)
wino_split_sum(const float* __restrict__ ws, const bf16* __restrict__ bias,
               bf16* __restrict__ out, int H, int W, int Cout, int Cout_p, long long M,
               int split) {
  const int quads = (Cout + 3) / 4;
  const long long idx = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (idx >= 4 * M * quads) return;
  const int col = 4 * (int)(idx % quads);
  const long long pix = idx / quads;  // (b, h, w) of the output
  const int wcol = (int)(pix % W);
  const int hrow = (int)((pix / W) % H);
  const long long b = pix / ((long long)W * H);
  const int q = 2 * (hrow & 1) + (wcol & 1);
  const long long m = (b * (H / 2) + hrow / 2) * (W / 2) + wcol / 2;
  float s[4];
  const float* p = ws + ((long long)q * M + m) * Cout_p + col;
  float4 v = *reinterpret_cast<const float4*>(p);
  s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
  for (int sp = 1; sp < split; ++sp) {
    v = *reinterpret_cast<const float4*>(p + (long long)sp * 4 * M * Cout_p);
    s[0] += v.x, s[1] += v.y, s[2] += v.z, s[3] += v.w;
  }
  bf16* dst = out + pix * Cout + col;
  if ((Cout & 3) == 0) {
    uint2 o;
    o.x = pack_bf16x2(s[0] + __bfloat162float(bias[col]), s[1] + __bfloat162float(bias[col + 1]));
    o.y = pack_bf16x2(s[2] + __bfloat162float(bias[col + 2]),
                      s[3] + __bfloat162float(bias[col + 3]));
    *reinterpret_cast<uint2*>(dst) = o;
  } else {
    for (int k = 0; k < 4 && col + k < Cout; ++k)
      dst[k] = __float2bfloat16_rn(s[k] + __bfloat162float(bias[col + k]));
  }
}

}  // namespace

// x [B, H, W, Cin] bf16 contiguous, H and W even; ut [16, Cout_p, Cin_p]
// bf16, the transformed weights transposed to K-major and zero-padded (Cin_p
// a multiple of 64, Cout_p of 64); bias [Cout] bf16; v scratch [16,
// B*H*W/4, Cin_p] bf16; ws fp32 scratch [split, 4, B*H*W/4, Cout_p] (unused
// when split == 1); out [B, H, W, Cout] bf16. The plan
// (ops/winograd.py:launch_plan): the split of the 16 * Cin_p / 64 product
// steps (1 .. that many) and whether row blocks run fastest. Returns a
// cudaError_t value (0 on success); launches only.
extern "C" int winograd_conv3x3_fwd(const void* x, const void* ut, const void* bias, void* v,
                                    void* ws, void* out, int B, int H, int W, int Cin,
                                    int Cout, int Cin_p, int Cout_p, int split, int m_fastest,
                                    void* stream) {
  const int nk = Cin_p / BK;
  if (H % 2 || W % 2 || Cin_p % BK || Cout_p % BN || Cin > Cin_p || Cout > Cout_p ||
      B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || split < 1 || split > 16 * nk ||
      (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * (H / 2) * (W / 2);
  if (16 * M > 0x7fffffffLL || 16LL * Cout_p > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long threads = M * (Cin_p / 8);
  const unsigned blocks = (unsigned)((threads + TRANSFORM_THREADS - 1) / TRANSFORM_THREADS);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* vb = static_cast<bf16*>(v);
  if (Cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0)
    wino_input_kernel<true><<<blocks, TRANSFORM_THREADS, 0, s>>>(xb, vb, H, W, Cin, Cin_p, M);
  else
    wino_input_kernel<false><<<blocks, TRANSFORM_THREADS, 0, s>>>(xb, vb, H, W, Cin, Cin_p, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  static const cudaError_t attr = allow_smem(wino_product_kernel, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map_v, map_u;
  if (make_sw128_map(&map_v, v, Cin_p, (int)(16 * M), BM) != 0 ||
      make_sw128_map(&map_u, ut, Cin_p, 16 * Cout_p, BN) != 0)
    return (int)cudaErrorInvalidValue;
  const long long items = (M + BM - 1) / BM * (Cout_p / BN) * split;
  wino_product_kernel<<<(unsigned)items, NTHREADS, SMEM, s>>>(
      map_v, map_u, static_cast<const bf16*>(bias), static_cast<bf16*>(out),
      static_cast<float*>(ws), H, W, Cout, Cout_p, M, nk, split, m_fastest);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long sums = 4 * M * ((Cout + 3) / 4);
  wino_split_sum<<<(unsigned)((sums + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const bf16*>(bias), static_cast<bf16*>(out), H,
      W, Cout, Cout_p, M, split);
  return (int)cudaGetLastError();
}
