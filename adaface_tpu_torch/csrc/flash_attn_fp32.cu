// Flash attention in fp32 on Hopper (sm_90a): the forward with its row
// log2-sum-exp, dq, and dk/dv/dbias, for fp32 q, k, v. It computes the
// function of the JAX package's Pallas kernels (adaface_tpu/ops/
// flash_attention.py: K1/K2/K4-K7 forward, K3a lse, K3b dq, K3c dk/dv/dbias)
// when the pipeline runs in fp32, where the bf16 kernels
// (flash_attn_packed.cu, flash_attn_bwd.cu) do not apply.
//
// Every product is an fp32 FFMA with fp32 accumulation: no tensor core, no
// TF32 (the JAX package asks for fp32 products). Scores are log2-domain:
//   s = (q . k) * scale * log2(e)
//   with a key bias: s = max(s + bias * log2(e), -100)
// Forward: an online base-2 softmax over key tiles of 64 (running row
// maximum m, running sum l), o = sum_j 2^(s_j - m) v_j / l, lse = m + log2 l.
// Under FLAG_EXP_BF16 (K1's arm) the scores are rounded to bf16 before exp2
// and p is rounded to bf16; the running maximum is then an integer, so every
// rescale by 2^(m_old - m_new) is exact and p equals bf16(2^bf16(s)) / 2^m.
// The lse is the unflagged function's under every flag. FLAG_MXU_SUM (the
// denominator sums the p that the value product takes) is the same function
// in fp32, where that p is p itself.
// Backward (p = 2^(s - lse), delta = rowsum(dO o) computed by the caller):
//   dq = ds K scale, dk = ds^T Q scale, dv = p^T dO, dbias_h = sum_q ds,
//   ds = p (dO v - delta), not zeroed where the floor clamped a score.
//
// Layout: q, k, v, o, dO, dq, dk, dv are packed [B, L, H*D] fp32 with a unit
// column stride and the batch and row strides given in `strides` (elements);
// head h is columns [h*D, (h+1)*D). The bias is fp32 [B, Lk]; lse and delta
// are fp32 [B, H, Lq]; dbias is fp32 [B, H, Lk] per head. Lengths need not be
// multiples of the tiles.
//
// What bounds it: the products, 4 B*H*Lq*Lk*d flops for the forward, at
// the card's fp32 FFMA rate (67 TFLOP/s on an H100 SXM); K and V of a head
// are re-read by each of its query blocks, mostly from L2.
//
// The forward (redesigned for Hopper; its design note is at its code
// below): both products register-blocked FFMA (8 or 4 rows by 8 keys, and
// 8 or 4 rows by 5 head columns a lane), K and V streamed by 16-byte
// cp.async through a 3-stage ring of 40-column chunks, row statistics in
// the lanes that own the row, and a launch plan (rows a CTA) chosen by the
// wrapper from the head dim and the grid.
//
// The backward (simple, a CTA of 256 threads per 64-row block of one head):
//   - the two operands of a score product sit transposed in shared memory
//     ([D][68]: 16-byte aligned float4 rows, the 64 rows/keys along the
//     fast axis), and each thread computes a 4x4 block of the 64x64 score
//     tile from float4 reads (16 FFMA per 8 values read);
//   - row statistics reduce over the 16 lanes of a half-warp that share a
//     row block (xor shuffles);
//   - the second product (ds K, p^T dO, ds^T Q) gives each thread one
//     row and every fourth of the D columns, accumulated in registers;
//   - launch bounds of one CTA an SM leave ptxas the registers it wants
//     (with the default bound it held the d40 dq to 64 and spilled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows (dq) or keys (dk/dv) a backward CTA owns
constexpr int BK = 64;   // rows of the streamed tile (keys of a forward tile)
constexpr int LD = 68;   // leading dimension of a transposed tile (floats)
constexpr int NT = 256;  // threads a CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCORE_FLOOR = -100.0f;
constexpr int FLAG_EXP_BF16 = 1, FLAG_MXU_SUM = 2;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rows [r0, r0 + 64) of one head of a packed tensor into t[D][LD]
// (transposed); rows at or past `len` are zeros.
template <int D>
__device__ __forceinline__ void load_t(float* t, const float* __restrict__ src,
                                       long long sl, int r0, int len) {
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, c = i - r * D;
    t[c * LD + r] = (r0 + r < len) ? src[(long long)(r0 + r) * sl + c] : 0.f;
  }
}

// acc[i][j] += sum_c a[c][ty*4+i] * b[c][tx*4+j] over the D rows of two
// transposed tiles.
template <int D>
__device__ __forceinline__ void block_4x4(float (&acc)[4][4], const float* a,
                                          const float* b, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(a + c * LD + ty * 4);
    const float4 y = *reinterpret_cast<const float4*>(b + c * LD + tx * 4);
    const float xa[4] = {x.x, x.y, x.z, x.w}, ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ya[j], acc[i][j]);
  }
}

// sums over the 16 lanes (one row block) of a half-warp
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------------------ forward
// The redesigned forward. A CTA owns `rows` query rows of one head and
// streams the head's keys in tiles of BK = 64 through a ring of STAGES
// shared-memory stages. A stage holds one CW-column chunk (40 head columns;
// 80 at d160 under the key split) of K or of V for the tile's 64 keys (and,
// with K's last chunk, the tile's key bias): a tile is NC = D / CW K
// stages, then NC V stages, and the next stages' 16-byte cp.async copies
// are in flight while this one computes. One __syncthreads a stage.
//
// Warps: a row group of WR rows is taken by KS warps (the key split), warp
// kh of them taking keys [kh 64 / KS, (kh + 1) 64 / KS) of every tile with
// its own online softmax; at the end the KS partial results of a row group
// merge through shared memory. The plan (rows and threads a CTA) comes from
// the wrapper (ops/flash_attention.py fwd_fp32_launch_plan): KS = 2 where
// one warp a row group would leave SMs with few warps.
//
// Lane (rg, cg) = (lane / 8, lane % 8) of a warp owns rows rg + 4 i (i < TM)
// of its row group: of the score tile, keys cg + 8 j (j < TN = 8 / KS) of
// its key range; of O, CW / 8 head columns of each chunk: 32 f + 4 cg .. + 3
// (f < CW / 32) and the rest of the chunk's columns split 8 ways. Both
// products are register-blocked FFMA: the score product reads TM float4 of
// Q and TN float4 of K per 4 depths for 4 TM TN FFMA; p V reads TM float4
// of p (4 keys each) and per key CW / 32 float4 and one or two floats of V
// for TM CW / 8 FFMA. A row's maximum, rescale and sum live in the 8 lanes that
// share rg (xor shuffles; each lane keeps a partial sum, reduced once at the
// end); p goes to the warp's own p tile in shared memory, row-major, where
// the p V lanes read it as float4 along the keys.
//
// Layout strides are chosen for the reads: rows LDC = CW + 4 floats apart
// put the 8 keys cg + 8 j (and Q's 4 rows rg, LDQ = D + 4) on distinct
// banks; p rows LDP = 72 apart put the 32 stores of (rg, cg) on distinct
// banks.

constexpr int LDP = BK + 8;  // floats between rows of a warp's p tile
constexpr int STAGES = 3;    // ring depth
constexpr int FWD_MAX_WARPS = 4;

template <int D, int KS>
struct FwdCfg {
  // head columns a stage holds: 80 at d160 under the key split, whose
  // stages of 40 columns are too short for their barrier
  static constexpr int CW = D == 160 && KS == 2 ? 80 : 40;
  static_assert(CW <= 4 * 32, "a stage's row is copied by at most one warp");
  static constexpr int LDC = CW + 4;         // floats between a stage's rows
  static constexpr int STAGE = BK * LDC + BK;  // floats a stage: 64 rows, the tile's bias
  static constexpr int NC = D / CW;          // chunks of the head dim
  static constexpr int NF4 = CW / 32;        // float4 of V a lane reads a key
  static constexpr int NR = CW % 32 / 8;     // and the single columns after them
  static constexpr int TM = D > 80 ? 4 : 8;  // rows a lane
  static constexpr int WR = 4 * TM;          // rows a warp (a row group)
  static constexpr int LDQ = D + 4;          // floats between rows of the Q tile
  // floats a lane hands over in the key split's merge: m, l, l2 and O
  static constexpr int XF = 3 * TM + NC * TM * CW / 8;
  // Q tile, ring, the warps' p tiles
  static constexpr size_t smem(int rows, int warps) {
    return (size_t)(rows * LDQ + STAGES * STAGE + warps * WR * LDP) * sizeof(float);
  }
};

struct FwdArgs {
  const float *q, *k, *v, *bias;
  float *o, *lse;
  int H, Lq, Lk;
  long long sbq, slq, sbk, slk, sbv, slv, sbo, slo;
  float sc_log2;
  int vec;  // every row start of q, k, v and o 16-byte aligned
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// All but this thread's newest STAGES - 2 groups of copies have landed.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// 16 bytes from src to dst (zeros if not `valid`): one copy when `vec`,
// else four of 4 bytes.
__device__ __forceinline__ void cp_async_4f(float* d, const float* s, bool valid, bool vec) {
  if (vec) {
    cp_async16(d, s, valid);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(d + e, s + e, valid);
  }
}

// Rows [r0, r0 + n) x columns [0, 4 C4) of one head of a packed tensor (row
// r at src + r sl) into dst, rows `ld` floats apart; rows at or past `len`
// are zeros. Thread t copies column 4 (t % C4) of rows t / C4, + T / C4, ...
// (T >= C4 threads), its addresses stepped, not recomputed.
template <int C4>
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src, long long sl,
                                          int r0, int n, int len, bool vec) {
  const int step = blockDim.x / C4, r = threadIdx.x / C4, c = 4 * (threadIdx.x - r * C4);
  if (r >= step) return;
  const float* s = src + (long long)(r0 + r) * sl + c;
  const long long ds = (long long)step * sl;
  for (int rr = r; rr < n; rr += step, s += ds) {
    const bool valid = r0 + rr < len;
    cp_async_4f(dst + rr * ld + c, valid ? s : src + c, valid, vec);
  }
}

// copy_rows for any number of threads (the Q tile, once a CTA).
template <int C4>
__device__ __forceinline__ void copy_rows_any(float* dst, int ld, const float* src,
                                              long long sl, int r0, int n, int len, bool vec) {
  for (int i = threadIdx.x; i < n * C4; i += blockDim.x) {
    const int r = i / C4, c = 4 * (i - r * C4);
    const bool valid = r0 + r < len;
    cp_async_4f(dst + r * ld + c, src + (valid ? (long long)(r0 + r) * sl : 0) + c, valid, vec);
  }
}

// Stage s of a CTA's sequence: tile t = s / (2 NC), its K chunks, then its V
// chunks; K's last chunk brings the tile's key bias (the softmax reads it
// before that stage's buffer is refilled).
template <int D, int KS, bool BIAS>
__device__ __forceinline__ void load_stage(float* ring, int s, const FwdArgs& a,
                                           const float* kb, const float* vb,
                                           const float* bb) {
  using C = FwdCfg<D, KS>;
  float* buf = ring + (s % STAGES) * C::STAGE;
  const int t = s / (2 * C::NC), w = s - t * 2 * C::NC, k0 = t * BK;
  const bool is_v = w >= C::NC;
  const int c = is_v ? w - C::NC : w;
  copy_rows<C::CW / 4>(buf, C::LDC, (is_v ? vb : kb) + c * C::CW, is_v ? a.slv : a.slk, k0,
                       BK, a.Lk, a.vec != 0);
  if (BIAS && w == C::NC - 1)
    for (int i = threadIdx.x; i < BK; i += blockDim.x)
      cp_async4(buf + BK * C::LDC + i, bb + (k0 + i < a.Lk ? k0 + i : 0), k0 + i < a.Lk);
}

// acc[i][j] += the chunk's part of q_(rg + 4i) . k_(cg + 8j), depths in order,
// RG rows of Q in registers at a time. qr: Q row rg at the chunk's first
// column; kr: the stage's row of key cg of this warp's range.
template <int TM, int TN, int RG, int LDQ, int CW, int LDC>
__device__ __forceinline__ void score_chunk(float (&acc)[TM][TN], const float* qr,
                                            const float* kr) {
#pragma unroll 2
  for (int k4 = 0; k4 < CW; k4 += 4) {
#pragma unroll
    for (int i0 = 0; i0 < TM; i0 += RG) {
      float4 x[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i)
        x[i] = *reinterpret_cast<const float4*>(qr + 4 * (i0 + i) * LDQ + k4);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 y = *reinterpret_cast<const float4*>(kr + 8 * j * LDC + k4);
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          float& c = acc[i0 + i][j];
          c = fmaf(x[i].x, y.x, c);
          c = fmaf(x[i].y, y.y, c);
          c = fmaf(x[i].z, y.z, c);
          c = fmaf(x[i].w, y.w, c);
        }
      }
    }
  }
}

// o[i][n] += sum_j p[rg + 4i][j] v[j][col_n] over the lane's CW / 8 columns
// of the chunk (the float4 at 32 f + 4 cg, then NR at 32 NF4 + NR cg), over
// the KW keys of this warp's range in order. pr: p row rg; vt: the V
// stage's row of the range's first key.
template <int TM, int KW, int NF4, int NR, int LDC>
__device__ __forceinline__ void pv_chunk(float (&o)[TM][4 * NF4 + NR], const float* pr,
                                         const float* vt, int cg) {
#pragma unroll 2
  for (int j4 = 0; j4 < KW; j4 += 4) {
    float4 p[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) p[i] = *reinterpret_cast<const float4*>(pr + 4 * i * LDP + j4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* vr = vt + (j4 + u) * LDC;
      float y[4 * NF4 + NR];
#pragma unroll
      for (int f = 0; f < NF4; ++f) {
        const float4 y4 = *reinterpret_cast<const float4*>(vr + 32 * f + 4 * cg);
        y[4 * f] = y4.x;
        y[4 * f + 1] = y4.y;
        y[4 * f + 2] = y4.z;
        y[4 * f + 3] = y4.w;
      }
#pragma unroll
      for (int e = 0; e < NR; ++e) y[4 * NF4 + e] = vr[32 * NF4 + NR * cg + e];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int e = 0; e < 4 * NF4 + NR; ++e) o[i][e] = fmaf(pu, y[e], o[i][e]);
      }
    }
  }
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, int KS, bool EXPBF16, bool BIAS>
__global__ void __launch_bounds__(32 * FWD_MAX_WARPS, 2)
    flash_fp32_fwd_kernel(const FwdArgs a) {
  using C = FwdCfg<D, KS>;
  constexpr int NC = C::NC, TM = C::TM, WR = C::WR, LDQ = C::LDQ, CW = C::CW, LDC = C::LDC;
  constexpr int NO = CW / 8;                // O columns a lane of each chunk
  constexpr int TN = 8 / KS, KW = BK / KS;  // keys a lane, a warp of each tile
  // Q rows a lane holds in registers at a time in the score product, and the
  // tile's key bias in registers or read where used: at d80 all 8 rows with
  // O's 80 accumulators spill at 255 registers, and under EXP_BF16 so do 4
  // with the bias in registers
  constexpr int RG = D == 80 ? (EXPBF16 ? 2 : 4) : TM;
  constexpr bool BIAS_REGS = !(D == 80 && EXPBF16);
  static_assert(FWD_MAX_WARPS / 2 * C::XF * 32 <=
                    FWD_MAX_WARPS / 2 * WR * LDQ + STAGES * C::STAGE,
                "the key split's merge fits in the Q tile and the ring");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rg = lane >> 3, cg = lane & 7;
  const int grp = warp / KS, kh = warp - grp * KS;  // row group, key range
  const int rows = (blockDim.x >> 5) / KS * WR;
  float* ring = qs + rows * LDQ;
  float* pr = ring + STAGES * C::STAGE + (warp * WR + rg) * LDP;  // this lane's p row rg
  const int q0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const float* kb = a.k + b * a.sbk + h * D;
  const float* vb = a.v + b * a.sbv + h * D;
  const float* bb = BIAS ? a.bias + (long long)b * a.Lk : nullptr;
  const int ntiles = (a.Lk + BK - 1) / BK, nstages = ntiles * 2 * NC;

  copy_rows_any<D / 4>(qs, LDQ, a.q + b * a.sbq + h * D, a.slq, q0, rows, a.Lq, a.vec != 0);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstages) load_stage<D, KS, BIAS>(ring, s, a, kb, vb, bb);
    cp_async_commit();
  }
  // stage s has landed for every thread, and every thread is done with the
  // stage before it, whose buffer takes stage s + STAGES - 1
  auto next_stage = [&](int s) -> const float* {
    cp_async_wait_ring();
    __syncthreads();
    if (s + STAGES - 1 < nstages) load_stage<D, KS, BIAS>(ring, s + STAGES - 1, a, kb, vb, bb);
    cp_async_commit();
    return ring + (s % STAGES) * C::STAGE;
  };

  float o[NC][TM][NO], m[TM], l[TM], l2[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = l2[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < NO; ++e) o[c][i][e] = 0.f;
  }
  const float* qr = qs + (grp * WR + rg) * LDQ;
  const int key0 = kh * KW + cg;  // this lane's first key of a tile

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    float acc[TM][TN], bl[TN];
    const float* kl = nullptr;  // K's last chunk, with the tile's bias
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* kt = next_stage(t * 2 * NC + c);
      score_chunk<TM, TN, RG, LDQ, CW, LDC>(acc, qr + c * CW, kt + key0 * LDC);
      kl = kt;
    }
    if (BIAS && BIAS_REGS)
#pragma unroll
      for (int j = 0; j < TN; ++j) bl[j] = __fmul_rn(kl[BK * LDC + key0 + 8 * j], LOG2E);
    // scores as the plain version rounds them, the online base-2 softmax,
    // p into the warp's p tile (read after the next stage's barrier)
    const bool ragged = k0 + BK > a.Lk;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float s[TN], mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = __fmul_rn(acc[i][j], a.sc_log2);
        if (BIAS)
          x = fmaxf(__fadd_rn(x, BIAS_REGS ? bl[j]
                                           : __fmul_rn(kl[BK * LDC + key0 + 8 * j], LOG2E)),
                    SCORE_FLOOR);
        if (ragged && k0 + key0 + 8 * j >= a.Lk) x = -INFINITY;
        s[j] = x;
        mt = fmaxf(mt, EXPBF16 ? bf16_round(x) : x);
      }
      mt = row_max(mt);
      const float m_new = fmaxf(m[i], EXPBF16 ? ceilf(mt) : mt);
      // a key range with no key yet (split keys, Lk <= 32) keeps m = -inf
      const float m_use = (KS > 1 && m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float ps = 0.f, ps2 = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float p = exp2f((EXPBF16 ? bf16_round(s[j]) : s[j]) - m_use);
        if (EXPBF16) {
          p = bf16_round(p);
          ps2 += exp2f(s[j] - m_use);
        }
        ps += p;
        pr[4 * i * LDP + cg + 8 * j] = p;
      }
      l[i] = l[i] * alpha + ps;
      if (EXPBF16) l2[i] = l2[i] * alpha + ps2;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < NO; ++e) o[c][i][e] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* vt = next_stage(t * 2 * NC + NC + c);
      pv_chunk<TM, KW, C::NF4, C::NR, LDC>(o[c], pr, vt + kh * KW * LDC, cg);
    }
  }

  if (KS > 1) {
    // the key ranges' partial results merge into warp kh = 0 of each row
    // group, lane by lane, through the Q tile and the ring
    cp_async_wait_all();
    __syncthreads();
    float* xs = qs + grp * C::XF * 32 + lane;
    if (kh == 1) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        xs[(3 * i) * 32] = m[i];
        xs[(3 * i + 1) * 32] = l[i];
        xs[(3 * i + 2) * 32] = l2[i];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < NO; ++e) xs[(3 * TM + (c * TM + i) * NO + e) * 32] = o[c][i][e];
      }
    }
    __syncthreads();
    if (kh != 0) return;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float m1 = xs[(3 * i) * 32], mm = fmaxf(m[i], m1);
      const float a0 = exp2f(m[i] - mm), a1 = exp2f(m1 - mm);
      l[i] = l[i] * a0 + xs[(3 * i + 1) * 32] * a1;
      if (EXPBF16) l2[i] = l2[i] * a0 + xs[(3 * i + 2) * 32] * a1;
      m[i] = mm;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < NO; ++e)
          o[c][i][e] = o[c][i][e] * a0 + xs[(3 * TM + (c * TM + i) * NO + e) * 32] * a1;
    }
  }

  const bool vec = a.vec != 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float lt = row_sum(l[i]);
    const float lt2 = EXPBF16 ? row_sum(l2[i]) : lt;
    const int r = q0 + grp * WR + rg + 4 * i;
    if (r >= a.Lq) continue;
    float* ob = a.o + b * a.sbo + (long long)r * a.slo + h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float* oc = ob + c * CW;
#pragma unroll
      for (int f = 0; f < C::NF4; ++f) {
        const float4 y = make_float4(o[c][i][4 * f] / lt, o[c][i][4 * f + 1] / lt,
                                     o[c][i][4 * f + 2] / lt, o[c][i][4 * f + 3] / lt);
        float* of = oc + 32 * f + 4 * cg;
        if (vec) {
          *reinterpret_cast<float4*>(of) = y;
        } else {
          of[0] = y.x;
          of[1] = y.y;
          of[2] = y.z;
          of[3] = y.w;
        }
      }
#pragma unroll
      for (int e = 0; e < C::NR; ++e)
        oc[32 * C::NF4 + C::NR * cg + e] = o[c][i][4 * C::NF4 + e] / lt;
    }
    if (a.lse != nullptr && cg == 0)
      a.lse[((long long)b * a.H + h) * a.Lq + r] = m[i] + log2f(lt2);
  }
}

// ----------------------------------------------------------------- backward
template <int D>
struct Dq {
  static constexpr int QT = 0, DOT = QT + D * LD, KT = DOT + D * LD, VT = KT + D * LD,
                       DS = VT + D * LD, BIAS = DS + BQ * LD, LSE = BIAS + BK,
                       DELTA = LSE + BQ, FLOATS = DELTA + BQ;
  static constexpr size_t SMEM = FLOATS * sizeof(float);
};

template <int D, bool BIAS>
__global__ void __launch_bounds__(NT, 1) flash_fp32_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ bias, float* __restrict__ dq,
    int H, int Lq, int Lk, long long sbq, long long slq, long long sbk, long long slk,
    long long sbv, long long slv, long long sbd, long long sld, long long sbg, long long slg,
    float sc_log2, float scale) {
  using S = Dq<D>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *qT = sm + S::QT, *doT = sm + S::DOT, *kT = sm + S::KT, *vT = sm + S::VT,
        *dss = sm + S::DS, *bs = sm + S::BIAS, *ls = sm + S::LSE, *dls = sm + S::DELTA;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int orow = tid >> 2, oc = tid & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long row0 = ((long long)b * H + h) * Lq;
  load_t<D>(qT, q + b * sbq + h * D, slq, q0, Lq);
  load_t<D>(doT, dout + b * sbd + h * D, sld, q0, Lq);
  if (tid < BQ) {
    ls[tid] = (q0 + tid < Lq) ? lse[row0 + q0 + tid] : 0.f;
    dls[tid] = (q0 + tid < Lq) ? delta[row0 + q0 + tid] : 0.f;
  }
  float acc_q[D / 4];
#pragma unroll
  for (int jj = 0; jj < D / 4; ++jj) acc_q[jj] = 0.f;
  const float* kb = k + b * sbk + h * D;
  const float* vb = v + b * sbv + h * D;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();
    load_t<D>(kT, kb, slk, k0, Lk);
    load_t<D>(vT, vb, slv, k0, Lk);
    if (BIAS && tid < BK)
      bs[tid] = (k0 + tid < Lk) ? bias[(long long)b * Lk + k0 + tid] * LOG2E : 0.f;
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    block_4x4<D>(s, qT, kT, ty, tx);
    block_4x4<D>(dp, doT, vT, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        float x = s[i][j] * sc_log2;
        if (BIAS) x = fmaxf(x + bs[c], SCORE_FLOOR);
        const float p = (k0 + c < Lk) ? exp2f(x - ls[r]) : 0.f;
        dss[r * LD + c] = p * (dp[i][j] - dls[r]);
      }
    }
    __syncthreads();
    const float* drow = dss + orow * LD;
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float ds = drow[j];
#pragma unroll
      for (int jj = 0; jj < D / 4; ++jj)
        acc_q[jj] = fmaf(ds, kT[(oc + 4 * jj) * LD + j], acc_q[jj]);
    }
  }
  const int r = q0 + orow;
  if (r < Lq) {
    float* gb = dq + b * sbg + (long long)r * slg + h * D + oc;
#pragma unroll
    for (int jj = 0; jj < D / 4; ++jj) gb[4 * jj] = acc_q[jj] * scale;
  }
}

template <int D>
struct Dkv {
  static constexpr int KT = 0, VT = KT + D * LD, QT = VT + D * LD, DOT = QT + D * LD,
                       PT = DOT + D * LD, DST = PT + BK * LD, BIAS = DST + BK * LD,
                       LSE = BIAS + BK, DELTA = LSE + BQ, FLOATS = DELTA + BQ;
  static constexpr size_t SMEM = FLOATS * sizeof(float);
};

template <int D, bool BIAS>
__global__ void __launch_bounds__(NT, 1) flash_fp32_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ bias, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dbias, int H, int Lq, int Lk, long long sbq,
    long long slq, long long sbk, long long slk, long long sbv, long long slv, long long sbd,
    long long sld, long long sbgk, long long slgk, long long sbgv, long long slgv,
    float sc_log2, float scale) {
  using S = Dkv<D>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *kT = sm + S::KT, *vT = sm + S::VT, *qT = sm + S::QT, *doT = sm + S::DOT,
        *pts = sm + S::PT, *dsts = sm + S::DST, *bs = sm + S::BIAS, *ls = sm + S::LSE,
        *dls = sm + S::DELTA;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int orow = tid >> 2, oc = tid & 3;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const long long row0 = ((long long)b * H + h) * Lq;
  load_t<D>(kT, k + b * sbk + h * D, slk, k0, Lk);
  load_t<D>(vT, v + b * sbv + h * D, slv, k0, Lk);
  if (BIAS && tid < BK)
    bs[tid] = (k0 + tid < Lk) ? bias[(long long)b * Lk + k0 + tid] * LOG2E : 0.f;
  float acc_k[D / 4], acc_v[D / 4], db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < D / 4; ++jj) acc_k[jj] = acc_v[jj] = 0.f;
  const float* qb = q + b * sbq + h * D;
  const float* db_ = dout + b * sbd + h * D;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    __syncthreads();
    load_t<D>(qT, qb, slq, q0, Lq);
    load_t<D>(doT, db_, sld, q0, Lq);
    if (tid < BQ) {
      ls[tid] = (q0 + tid < Lq) ? lse[row0 + q0 + tid] : 0.f;
      dls[tid] = (q0 + tid < Lq) ? delta[row0 + q0 + tid] : 0.f;
    }
    __syncthreads();
    // transposed tiles: rows are this CTA's keys, columns the tile's queries
    float s[4][4] = {}, dp[4][4] = {};
    block_4x4<D>(s, kT, qT, ty, tx);
    block_4x4<D>(dp, vT, doT, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        float x = s[i][j] * sc_log2;
        if (BIAS) x = fmaxf(x + bs[kr], SCORE_FLOOR);
        const float p = (q0 + c < Lq) ? exp2f(x - ls[c]) : 0.f;
        const float ds = p * (dp[i][j] - dls[c]);
        pts[kr * LD + c] = p;
        dsts[kr * LD + c] = ds;
        db[i] += ds;
      }
    }
    __syncthreads();
    const float* prow = pts + orow * LD;
    const float* drow = dsts + orow * LD;
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      const float p = prow[r], ds = drow[r];
#pragma unroll
      for (int jj = 0; jj < D / 4; ++jj) {
        acc_v[jj] = fmaf(p, doT[(oc + 4 * jj) * LD + r], acc_v[jj]);
        acc_k[jj] = fmaf(ds, qT[(oc + 4 * jj) * LD + r], acc_k[jj]);
      }
    }
  }
  const int kr = k0 + orow;
  if (kr < Lk) {
    float* gk = dk + b * sbgk + (long long)kr * slgk + h * D + oc;
    float* gv = dv + b * sbgv + (long long)kr * slgv + h * D + oc;
#pragma unroll
    for (int jj = 0; jj < D / 4; ++jj) {
      gk[4 * jj] = acc_k[jj] * scale;
      gv[4 * jj] = acc_v[jj];
    }
  }
  if (dbias != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float t = half_sum(db[i]);
      const int key = k0 + ty * 4 + i;
      if (tx == 0 && key < Lk) dbias[((long long)b * H + h) * Lk + key] = t;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D, int KS, bool EXPBF16, bool BIAS>
int fwd(const FwdArgs& a, int B, int rows, int warps, cudaStream_t s) {
  using C = FwdCfg<D, KS>;
  static const cudaError_t attr = allow_smem(flash_fp32_fwd_kernel<D, KS, EXPBF16, BIAS>,
                                             C::smem(FWD_MAX_WARPS * C::WR, FWD_MAX_WARPS));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.Lq + rows - 1) / rows, a.H, B);
  flash_fp32_fwd_kernel<D, KS, EXPBF16, BIAS><<<grid, 32 * warps, C::smem(rows, warps), s>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int KS>
int fwd_flags(int flags, const FwdArgs& a, int B, int rows, int warps, cudaStream_t s) {
  const bool bias = a.bias != nullptr;
  if (flags & FLAG_EXP_BF16)
    return bias ? fwd<D, KS, true, true>(a, B, rows, warps, s)
                : fwd<D, KS, true, false>(a, B, rows, warps, s);
  return bias ? fwd<D, KS, false, true>(a, B, rows, warps, s)
              : fwd<D, KS, false, false>(a, B, rows, warps, s);
}

// The plans this build has: 1, 2 or 4 warps a CTA, each row group of WR
// rows taken by one warp or split over two (KS).
template <int D>
int fwd_plan(int flags, const FwdArgs& a, int B, int rows, int threads, cudaStream_t s) {
  const int warps = threads / 32, groups = rows / FwdCfg<D, 1>::WR;
  if (threads != 32 * warps || rows != groups * FwdCfg<D, 1>::WR || groups < 1 ||
      (warps != 1 && warps != 2 && warps != FWD_MAX_WARPS))
    return (int)cudaErrorInvalidValue;
  if (warps == groups) return fwd_flags<D, 1>(flags, a, B, rows, warps, s);
  if (warps == 2 * groups) return fwd_flags<D, 2>(flags, a, B, rows, warps, s);
  return (int)cudaErrorInvalidValue;
}

template <int D, bool BIAS>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* bias, void* dq, int B, int H, int Lq, int Lk,
              const long long* st, float sc_log2, float scale, cudaStream_t s) {
  constexpr size_t smem = Dq<D>::SMEM;
  static const cudaError_t attr = allow_smem(flash_fp32_dq_kernel<D, BIAS>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fp32_dq_kernel<D, BIAS><<<grid, NT, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<float*>(dq), H, Lq, Lk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], sc_log2, scale);
  return (int)cudaGetLastError();
}

template <int D, bool BIAS>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* bias, void* dk, void* dv,
               void* dbias, int B, int H, int Lq, int Lk, const long long* st, float sc_log2,
               float scale, cudaStream_t s) {
  constexpr size_t smem = Dkv<D>::SMEM;
  static const cudaError_t attr = allow_smem(flash_fp32_dkv_kernel<D, BIAS>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Lk + BK - 1) / BK, H, B);
  flash_fp32_dkv_kernel<D, BIAS><<<grid, NT, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dbias), H, Lq, Lk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], sc_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Built for the UNet's head dims 40, 80 and 160. `rows` and `threads` are
// the plan's query rows and threads a CTA (ops/flash_attention.py
// fwd_fp32_launch_plan): 1, 2 or 4 warps, taking row groups of 32 rows (16
// at d160) one warp or two warps a group; any other plan is refused.
// `strides` holds the batch and row strides, in elements, of q, k, v and o
// (8 values). `bias` and `lse` may be null. `flags` is a mask of
// FLAG_EXP_BF16 (1) and FLAG_MXU_SUM (2); any other bit is refused. Returns
// a cudaError_t value (0 on success).
extern "C" int flash_attn_fp32_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* o, void* lse, int B, int H, int Lq,
                                   int Lk, int D, int flags, int rows, int threads,
                                   const long long* strides, float sc_log2, void* stream) {
  if (flags & ~(FLAG_EXP_BF16 | FLAG_MXU_SUM)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  const uintptr_t starts = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  bool vec = starts % 16 == 0;
  for (int i = 0; i < 8; ++i) vec = vec && st[i] % 4 == 0;
  const FwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(bias),
                  static_cast<float*>(o), static_cast<float*>(lse), H, Lq, Lk,
                  st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], sc_log2, vec ? 1 : 0};
  switch (D) {
    case 40:
      return fwd_plan<40>(flags, a, B, rows, threads, s);
    case 80:
      return fwd_plan<80>(flags, a, B, rows, threads, s);
    case 160:
      return fwd_plan<160>(flags, a, B, rows, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// `strides` holds the batch and row strides of q, k, v, dO and dq (10
// values). `bias` may be null.
extern "C" int flash_attn_fp32_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* bias, void* dq, int B, int H, int Lq,
                                      int Lk, int D, const long long* strides, float sc_log2,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(d)                                                                          \
  return bias != nullptr ? dq_launch<d, true>(q, k, v, dout, lse, delta, bias, dq, B, H, \
                                              Lq, Lk, strides, sc_log2, scale, s)       \
                         : dq_launch<d, false>(q, k, v, dout, lse, delta, bias, dq, B, H, \
                                               Lq, Lk, strides, sc_log2, scale, s)
  switch (D) {
    case 40:
      DQ(40);
    case 80:
      DQ(80);
    case 160:
      DQ(160);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DQ
}

// `strides` holds the batch and row strides of q, k, v, dO, dk and dv (12
// values). `bias` and `dbias` may be null.
extern "C" int flash_attn_fp32_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* bias, void* dk, void* dv, void* dbias,
                                       int B, int H, int Lq, int Lk, int D,
                                       const long long* strides, float sc_log2, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(d)                                                                             \
  return bias != nullptr                                                                   \
             ? dkv_launch<d, true>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, \
                                   Lk, strides, sc_log2, scale, s)                          \
             : dkv_launch<d, false>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H,   \
                                    Lq, Lk, strides, sc_log2, scale, s)
  switch (D) {
    case 40:
      DKV(40);
    case 80:
      DKV(80);
    case 160:
      DKV(160);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DKV
}
