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
// What bounds it: the products, 4 B*H*Lq*Lk*d flops for the forward, 6 for
// dq and 8 for dk/dv, at the card's fp32 FFMA rate (67 TFLOP/s on an H100
// SXM); the streamed side of a head is re-read by each of its CTAs, mostly
// from L2.
//
// Both directions are built alike (design notes at their code below):
// register-blocked FFMA in every product (8 or 4 resident rows by 8
// streamed rows a lane in the score products; float4 reads of a
// warp-private p / ds tile and of the streamed rows in the second
// products), the streamed side by 16-byte cp.async through a ring of
// 40-column chunks (80 at d160 under the forward's key split), row
// statistics in the lanes that own the row, and a launch plan (rows a CTA,
// threads) chosen by the wrapper from the head dim and the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;  // rows of a streamed tile (keys, or query rows for dk/dv)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCORE_FLOOR = -100.0f;
constexpr int FLAG_EXP_BF16 = 1, FLAG_MXU_SUM = 2;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
// The redesigned backward: dq, and dk/dv/dbias, each a launch of CTAs of 1,
// 2 or 4 warps (the plan, ops/flash_attention.py bwd_fp32_launch_plan) that
// hold a block of rows resident and stream the other side in tiles of BK =
// 64 rows through a ring of BWD_STAGES shared-memory stages of 40 head
// columns, by 16-byte cp.async (4-byte copies where rows are not 16-byte
// aligned), the next stage's copies in flight while this one computes and
// one __syncthreads a stage. Where the grid would run its last wave with
// few CTAs (L1024 d80) or leave SMs idle (L256 d160), the plan splits the
// streamed tiles into slices, one CTA each; the slices' partials go to a
// workspace and a second launch sums them in slice order, so two launches
// agree bit for bit.
//
//   dq: a CTA holds WR query rows a warp of Q and dO and streams K and V. A
//   key tile is NC = D / 40 stages of K (s = Q K^T), NC of V (dp = dO V^T)
//   and NC of K again (dq += ds K): 3 NC stages. K's last chunk brings the
//   tile's key bias. lse and delta of the CTA's rows sit in shared memory
//   (in registers they pushed 8 rows a lane at d80 over 255).
//   dk/dv: a CTA holds WR keys a warp of K and V and streams Q and dO. A
//   query tile is NC stages of Q (s^T = K Q^T; the last brings the tile's
//   lse), NC of dO (dp^T = V dO^T and dv += p^T dO, since p is known after
//   the first pass; the last brings delta) and NC of Q again (dk += ds^T Q).
//   The key bias of the lane's keys sits in registers; dbias is each lane's
//   sum of ds over its queries, reduced over the 8 lanes of a row at the end.
//
// Lane (rg, cg) = (lane / 8, lane % 8) owns rows rg + 4 i (i < TR) of its
// warp's WR = 4 TR resident rows, and columns cg + 8 j (j < 8) of the 64 of
// the score tile (keys for dq, query rows for dk/dv): both score products
// read TR float4 of the resident tile and 8 float4 of the stage per 4
// depths for 32 TR FFMA (the forward's score_chunk). p, then ds, go to the
// warp's own tile in shared memory, [resident row][streamed row] (row-major
// p for dq, p^T for dk/dv), rows LDP = 72 apart so that the 32 stores of a
// warp fall on distinct banks; the second products read it as float4 along
// the streamed rows and each stage row as float4 + one float (the lane's
// CW / 8 columns of the chunk, as the forward's p V: pv_chunk), 4 TR FFMA
// per 4 + 5 / 4 floats read a streamed row. No transposes and no atomics:
// every output element is one lane's sum in a fixed order (under a split,
// the slices' sums added in slice order).
//
// Rows a lane: dq 8 at d40, 4 at d80 and d160 (8 at d80 took shared memory
// for one 4-warp CTA an SM and ran 12-14% slower); dk/dv 8 at d40, 4 at d80 and
// 2 at d160, since a lane holds both dk's and dv's accumulators (2 TR D / 8
// floats; 4 rows spilled at d160). Roundings follow the plain version
// (scores x * sc_log2, + bias * log2 e, then the floor; p = exp2(s - lse);
// ds = p (dp - delta)).

constexpr int BWD_STAGES = 2;  // ring depth of the backward
constexpr int BWD_MAX_WARPS = 4;

template <int D, bool DKV>
struct BwdCfg {
  static constexpr int CW = 40;                // head columns a stage holds
  static constexpr int LDC = CW + 4;           // floats between a stage's rows
  static constexpr int STAGE = BK * LDC + BK;  // floats a stage: 64 rows, the tile's vector
  static constexpr int NC = D / CW;            // chunks of the head dim
  static constexpr int NO = CW / 8;            // columns of each chunk a lane accumulates
  // resident rows a lane
  static constexpr int TR = DKV ? (D == 40 ? 8 : D == 80 ? 4 : 2) : (D > 40 ? 4 : 8);
  static constexpr int WR = 4 * TR;  // resident rows a warp
  // resident rows a lane reads into registers at a time in the score products
  static constexpr int RG = DKV && D == 40 ? 4 : TR;
  static constexpr int LDR = D + 4;  // floats between rows of a resident tile
  // the two resident tiles, the ring, the warps' p / ds tiles; dq also the
  // resident rows' lse and delta
  static constexpr size_t smem(int warps) {
    return (size_t)(2 * warps * WR * LDR + BWD_STAGES * STAGE + warps * WR * LDP +
                    (DKV ? 0 : 2 * warps * WR)) *
           sizeof(float);
  }
};

struct BwdArgs {
  const float *q, *k, *v, *dout, *lse, *delta, *bias;
  float *g0, *g1, *dbias;  // dq; or dk, dv, dbias
  int H, Lq, Lk;
  long long sbq, slq, sbk, slk, sbv, slv, sbd, sld, sbg0, slg0, sbg1, slg1;
  float sc_log2, scale;
  int vec;    // every row start of the packed operands and outputs 16-byte aligned
  int split;  // slices of the streamed tiles; above 1, each slice's partial goes to ws
  float* ws;  // [split][the outputs, each packed and contiguous; 16-byte aligned slices]
};

// The streamed tiles [t0, t0 + n) of CTA x's slice (x % split of the
// split's slices, slice s taking tiles [s T / split, (s + 1) T / split) of
// the T tiles of `len` rows), and x's resident block x / split.
struct Slice {
  int block, index, t0, n;
};
__device__ __forceinline__ Slice slice_of(int len, int split) {
  const int tiles = (len + BK - 1) / BK, index = blockIdx.x % split;
  const int t0 = index * tiles / split;
  return {(int)blockIdx.x / split, index, t0, (index + 1) * tiles / split - t0};
}

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage s of a backward CTA's sequence: tile t = t0 + s / (3 NC), pass p =
// (s % 3 NC) / NC, chunk c. Passes 0 and 2 copy chunk c of A (K for dq, Q
// for dk/dv), pass 1 of B (V; dO), rows [64 t, 64 t + 64) (zeros at or past
// len); the last chunk of pass 0 brings the tile's 64 values of v0 (the key
// bias; the lse), that of pass 1 those of v1 (none; delta), where given.
template <int D, bool DKV>
__device__ __forceinline__ void bwd_stage(float* ring, int s, int t0, const float* A,
                                          long long sla,
                                          const float* B, long long slb, const float* v0,
                                          const float* v1, int len, bool vec) {
  using C = BwdCfg<D, DKV>;
  float* buf = ring + (s % BWD_STAGES) * C::STAGE;
  const int t = s / (3 * C::NC), w = s - t * 3 * C::NC, pass = w / C::NC;
  const int c = w - pass * C::NC, r0 = (t0 + t) * BK;
  copy_rows<C::CW / 4>(buf, C::LDC, (pass == 1 ? B : A) + c * C::CW, pass == 1 ? slb : sla, r0,
                       BK, len, vec);
  const float* vv = pass == 0 ? v0 : pass == 1 ? v1 : nullptr;
  if (vv != nullptr && c == C::NC - 1)
    for (int i = threadIdx.x; i < BK; i += blockDim.x)
      cp_async4(buf + BK * C::LDC + i, vv + (r0 + i < len ? r0 + i : 0), r0 + i < len);
}

// Rows r0 + 4 i (i < TR) of one head of a packed output (row r at dst + r
// sl): lane cg's columns of each chunk (as pv_chunk holds them) times `mul`;
// rows at or past len are skipped.
template <int NC, int TR, int CW>
__device__ __forceinline__ void store_rows(float* dst, long long sl, int r0, int len,
                                           const float (&g)[NC][TR][CW / 8], float mul, int cg,
                                           bool vec) {
  constexpr int NF4 = CW / 32, NR = CW % 32 / 8;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = r0 + 4 * i;
    if (r >= len) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float* oc = dst + (long long)r * sl + c * CW;
#pragma unroll
      for (int f = 0; f < NF4; ++f) {
        const float4 y = make_float4(g[c][i][4 * f] * mul, g[c][i][4 * f + 1] * mul,
                                     g[c][i][4 * f + 2] * mul, g[c][i][4 * f + 3] * mul);
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
      for (int e = 0; e < NR; ++e) oc[32 * NF4 + NR * cg + e] = g[c][i][4 * NF4 + e] * mul;
    }
  }
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(32 * BWD_MAX_WARPS, 2)
    flash_fp32_dq_kernel(const BwdArgs a) {
  using C = BwdCfg<D, false>;
  constexpr int NC = C::NC, TR = C::TR, WR = C::WR, LDR = C::LDR, CW = C::CW, LDC = C::LDC;
  constexpr int TN = BK / 8;  // keys a lane of a tile
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rg = lane >> 3, cg = lane & 7;
  const int rows = (blockDim.x >> 5) * WR;
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + rows * LDR;
  float* ring = dos + rows * LDR;
  float* pr = ring + BWD_STAGES * C::STAGE + (warp * WR + rg) * LDP;  // this lane's row rg
  float* ls = ring + BWD_STAGES * C::STAGE + rows * LDP;  // the rows' lse, then delta
  const Slice sl = slice_of(a.Lk, a.split);  // this CTA's key tiles
  const int q0 = sl.block * rows, h = blockIdx.y, b = blockIdx.z;
  const bool vec = a.vec != 0;
  const float* kb = a.k + b * a.sbk + h * D;
  const float* vb = a.v + b * a.sbv + h * D;
  const float* bb = BIAS ? a.bias + (long long)b * a.Lk : nullptr;
  const int ntiles = sl.n, nstages = ntiles * 3 * NC;

  copy_rows_any<D / 4>(qs, LDR, a.q + b * a.sbq + h * D, a.slq, q0, rows, a.Lq, vec);
  copy_rows_any<D / 4>(dos, LDR, a.dout + b * a.sbd + h * D, a.sld, q0, rows, a.Lq, vec);
#pragma unroll
  for (int s = 0; s < BWD_STAGES - 1; ++s) {
    if (s < nstages)
      bwd_stage<D, false>(ring, s, sl.t0, kb, a.slk, vb, a.slv, bb, nullptr, a.Lk, vec);
    cp_async_commit();
  }
  // stage s has landed for every thread, and every thread is done with the
  // stage before it, whose buffer takes stage s + BWD_STAGES - 1
  auto next_stage = [&](int s) -> const float* {
    cp_async_wait_n<BWD_STAGES - 2>();
    __syncthreads();
    if (s + BWD_STAGES - 1 < nstages)
      bwd_stage<D, false>(ring, s + BWD_STAGES - 1, sl.t0, kb, a.slk, vb, a.slv, bb, nullptr,
                          a.Lk, vec);
    cp_async_commit();
    return ring + (s % BWD_STAGES) * C::STAGE;
  };

  const long long row0 = ((long long)b * a.H + h) * a.Lq;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {  // read after the first barrier
    const bool in = q0 + i < a.Lq;
    ls[i] = in ? a.lse[row0 + q0 + i] : 0.f;
    ls[rows + i] = in ? a.delta[row0 + q0 + i] : 0.f;
  }
  const int r0 = q0 + warp * WR + rg;  // this lane's first row
  const float* lr = ls + warp * WR + rg;  // its lse at lr[4 i], delta at lr[rows + 4 i]
  float g[NC][TR][CW / 8];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < CW / 8; ++e) g[c][i][e] = 0.f;
  }
  const float* qr = qs + (warp * WR + rg) * LDR;
  const float* dr = dos + (warp * WR + rg) * LDR;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = (sl.t0 + t) * BK, s0 = t * 3 * NC;
    float acc[TR][TN];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    const float* kl = nullptr;  // K's last chunk, with the tile's bias
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* kt = next_stage(s0 + c);
      score_chunk<TR, TN, C::RG, LDR, CW, LDC>(acc, qr + c * CW, kt + cg * LDC);
      kl = kt;
    }
    // p as the plain version rounds it, into the warp's tile
    float bl[TN];
    if (BIAS)
#pragma unroll
      for (int j = 0; j < TN; ++j) bl[j] = __fmul_rn(kl[BK * LDC + cg + 8 * j], LOG2E);
    const bool ragged = k0 + BK > a.Lk;
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = __fmul_rn(acc[i][j], a.sc_log2);
        if (BIAS) x = fmaxf(__fadd_rn(x, bl[j]), SCORE_FLOOR);
        float p = exp2f(x - lr[4 * i]);
        if (ragged && k0 + cg + 8 * j >= a.Lk) p = 0.f;
        pr[4 * i * LDP + cg + 8 * j] = p;
        acc[i][j] = 0.f;
      }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* vt = next_stage(s0 + NC + c);
      score_chunk<TR, TN, C::RG, LDR, CW, LDC>(acc, dr + c * CW, vt + cg * LDC);
    }
    // ds = p (dp - delta) over this lane's own p
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float* pp = pr + 4 * i * LDP + cg + 8 * j;
        *pp = *pp * (acc[i][j] - lr[rows + 4 * i]);
      }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* kt = next_stage(s0 + 2 * NC + c);
      pv_chunk<TR, BK, CW / 32, CW % 32 / 8, LDC>(g[c], pr, kt, cg);
    }
  }
  if (a.split == 1) {
    store_rows<NC, TR, CW>(a.g0 + b * a.sbg0 + h * D, a.slg0, r0, a.Lq, g, a.scale, cg, vec);
  } else {  // this slice's dq, packed [B, Lq, H D]
    const long long ld = (long long)a.H * D;
    store_rows<NC, TR, CW>(a.ws + ((sl.index * gridDim.z + b) * (long long)a.Lq) * ld + h * D,
                           ld, r0, a.Lq, g, a.scale, cg, true);
  }
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(32 * BWD_MAX_WARPS, 2)
    flash_fp32_dkv_kernel(const BwdArgs a) {
  using C = BwdCfg<D, true>;
  constexpr int NC = C::NC, TR = C::TR, WR = C::WR, LDR = C::LDR, CW = C::CW, LDC = C::LDC;
  constexpr int TN = BK / 8;  // query rows a lane of a tile
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rg = lane >> 3, cg = lane & 7;
  const int keys = (blockDim.x >> 5) * WR;
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + keys * LDR;
  float* ring = vs + keys * LDR;
  float* pr = ring + BWD_STAGES * C::STAGE + (warp * WR + rg) * LDP;  // this lane's key rg
  const Slice sl = slice_of(a.Lq, a.split);  // this CTA's query tiles
  const int k0 = sl.block * keys, h = blockIdx.y, b = blockIdx.z;
  const bool vec = a.vec != 0;
  const float* qb = a.q + b * a.sbq + h * D;
  const float* db = a.dout + b * a.sbd + h * D;
  const long long row0 = ((long long)b * a.H + h) * a.Lq;
  const float* lb = a.lse + row0;
  const float* eb = a.delta + row0;
  const int ntiles = sl.n, nstages = ntiles * 3 * NC;

  copy_rows_any<D / 4>(ks, LDR, a.k + b * a.sbk + h * D, a.slk, k0, keys, a.Lk, vec);
  copy_rows_any<D / 4>(vs, LDR, a.v + b * a.sbv + h * D, a.slv, k0, keys, a.Lk, vec);
#pragma unroll
  for (int s = 0; s < BWD_STAGES - 1; ++s) {
    if (s < nstages) bwd_stage<D, true>(ring, s, sl.t0, qb, a.slq, db, a.sld, lb, eb, a.Lq, vec);
    cp_async_commit();
  }
  auto next_stage = [&](int s) -> const float* {
    cp_async_wait_n<BWD_STAGES - 2>();
    __syncthreads();
    if (s + BWD_STAGES - 1 < nstages)
      bwd_stage<D, true>(ring, s + BWD_STAGES - 1, sl.t0, qb, a.slq, db, a.sld, lb, eb, a.Lq,
                         vec);
    cp_async_commit();
    return ring + (s % BWD_STAGES) * C::STAGE;
  };

  const int key0 = k0 + warp * WR + rg;  // this lane's first key
  float bl[TR], dsum[TR], gk[NC][TR][CW / 8], gv[NC][TR][CW / 8];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    bl[i] = BIAS && key0 + 4 * i < a.Lk
                ? __fmul_rn(a.bias[(long long)b * a.Lk + key0 + 4 * i], LOG2E)
                : 0.f;
    dsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < CW / 8; ++e) gk[c][i][e] = gv[c][i][e] = 0.f;
  }
  const float* kr = ks + (warp * WR + rg) * LDR;
  const float* vr = vs + (warp * WR + rg) * LDR;

  for (int t = 0; t < ntiles; ++t) {
    const int q0 = (sl.t0 + t) * BK, s0 = t * 3 * NC;
    float acc[TR][TN];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    const float* ql = nullptr;  // Q's last chunk, with the tile's lse
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* qt = next_stage(s0 + c);
      score_chunk<TR, TN, C::RG, LDR, CW, LDC>(acc, kr + c * CW, qt + cg * LDC);
      ql = qt;
    }
    // p^T as the plain version rounds it, into the warp's tile
    float lq[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) lq[j] = ql[BK * LDC + cg + 8 * j];
    const bool ragged = q0 + BK > a.Lq;
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = __fmul_rn(acc[i][j], a.sc_log2);
        if (BIAS) x = fmaxf(__fadd_rn(x, bl[i]), SCORE_FLOOR);
        float p = exp2f(x - lq[j]);
        if (ragged && q0 + cg + 8 * j >= a.Lq) p = 0.f;
        pr[4 * i * LDP + cg + 8 * j] = p;
        acc[i][j] = 0.f;
      }
    // dp^T, and dv += p^T dO chunk by chunk
    const float* dlast = nullptr;  // dO's last chunk, with the tile's delta
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* dt = next_stage(s0 + NC + c);
      score_chunk<TR, TN, C::RG, LDR, CW, LDC>(acc, vr + c * CW, dt + cg * LDC);
      pv_chunk<TR, BK, CW / 32, CW % 32 / 8, LDC>(gv[c], pr, dt, cg);
      dlast = dt;
    }
    float dj[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) dj[j] = dlast[BK * LDC + cg + 8 * j];
    __syncwarp();  // every lane of the warp is done reading p
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float* pp = pr + 4 * i * LDP + cg + 8 * j;
        const float ds = *pp * (acc[i][j] - dj[j]);
        *pp = ds;
        dsum[i] += ds;
      }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* qt = next_stage(s0 + 2 * NC + c);
      pv_chunk<TR, BK, CW / 32, CW % 32 / 8, LDC>(gk[c], pr, qt, cg);
    }
  }
  // the outputs, or this slice's partials: dk, dv packed [B, Lk, H D], then
  // dbias [B, H, Lk] (its length rounded up to 4 floats)
  const long long ld = (long long)a.H * D, n = (long long)gridDim.z * a.Lk * ld;
  float* part = a.ws + sl.index * (2 * n + (a.dbias != nullptr ? (n / D + 3) / 4 * 4 : 0));
  if (a.split == 1) {
    store_rows<NC, TR, CW>(a.g0 + b * a.sbg0 + h * D, a.slg0, key0, a.Lk, gk, a.scale, cg, vec);
    store_rows<NC, TR, CW>(a.g1 + b * a.sbg1 + h * D, a.slg1, key0, a.Lk, gv, 1.f, cg, vec);
  } else {
    store_rows<NC, TR, CW>(part + b * a.Lk * ld + h * D, ld, key0, a.Lk, gk, a.scale, cg, true);
    store_rows<NC, TR, CW>(part + n + b * a.Lk * ld + h * D, ld, key0, a.Lk, gv, 1.f, cg, true);
  }
  float* dbias = a.split == 1 ? a.dbias : part + 2 * n;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const float t = row_sum(dsum[i]);
    if (a.dbias != nullptr && cg == 0 && key0 + 4 * i < a.Lk)
      dbias[((long long)b * a.H + h) * a.Lk + key0 + 4 * i] = t;
  }
}

// A split's outputs: element i of the n = n0 + n1 + n2 of each slice's
// partials (slice s at ws + s stride), summed in slice order, to o0[i],
// o1[i - n0] or o2[i - n0 - n1].
__global__ void flash_fp32_bwd_sum_kernel(const float* __restrict__ ws, int split,
                                          long long stride, long long n, float* o0,
                                          long long n0, float* o1, long long n1, float* o2) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = ws[i];
    for (int s = 1; s < split; ++s) acc += ws[s * stride + i];
    if (i < n0)
      o0[i] = acc;
    else if (i < n0 + n1)
      o1[i - n0] = acc;
    else
      o2[i - n0 - n1] = acc;
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

template <int D, bool DKV, bool BIAS>
int bwd_launch(const BwdArgs& a, int B, int warps, cudaStream_t s) {
  using C = BwdCfg<D, DKV>;
  void (*kernel)(const BwdArgs) =
      DKV ? flash_fp32_dkv_kernel<D, BIAS> : flash_fp32_dq_kernel<D, BIAS>;
  static const cudaError_t attr = allow_smem(kernel, C::smem(BWD_MAX_WARPS));
  if (attr != cudaSuccess) return (int)attr;
  const int per = warps * C::WR;
  const dim3 grid(((DKV ? a.Lk : a.Lq) + per - 1) / per * a.split, a.H, B);
  kernel<<<grid, 32 * warps, C::smem(warps), s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return (int)err;
  // the slices' partials summed in slice order
  const long long n0 = (long long)B * (DKV ? a.Lk : a.Lq) * a.H * D, n1 = DKV ? n0 : 0;
  const long long n2 = DKV && a.dbias != nullptr ? n0 / D : 0, n = n0 + n1 + n2;
  const long long blocks = (n + 255) / 256;
  flash_fp32_bwd_sum_kernel<<<(int)(blocks < 1056 ? blocks : 1056), 256, 0, s>>>(
      a.ws, a.split, n0 + n1 + (n2 + 3) / 4 * 4, n, a.g0, n0, a.g1, n1, a.dbias);
  return (int)cudaGetLastError();
}

// The plans this build has: 1, 2 or 4 warps a CTA, WR resident rows each;
// a split of 1 up to the streamed tiles, above 1 with a workspace and
// packed, contiguous outputs.
template <int D, bool DKV>
int bwd_plan(const BwdArgs& a, int B, int rows, int threads, cudaStream_t s) {
  const int warps = threads / 32, len = DKV ? a.Lq : a.Lk;
  const long long ld = (long long)a.H * D;
  const bool packed = a.sbg0 == (DKV ? a.Lk : a.Lq) * ld && a.slg0 == ld &&
                      (!DKV || (a.sbg1 == a.Lk * ld && a.slg1 == ld));
  if (threads != 32 * warps || (warps != 1 && warps != 2 && warps != BWD_MAX_WARPS) ||
      rows != warps * BwdCfg<D, DKV>::WR || a.split < 1 || a.split > (len + BK - 1) / BK ||
      (a.split > 1 &&
       (a.ws == nullptr || reinterpret_cast<uintptr_t>(a.ws) % 16 != 0 || !packed)))
    return (int)cudaErrorInvalidValue;
  return a.bias != nullptr ? bwd_launch<D, DKV, true>(a, B, warps, s)
                           : bwd_launch<D, DKV, false>(a, B, warps, s);
}

template <bool DKV>
int bwd_dims(const BwdArgs& a, int B, int D, int rows, int threads, void* stream) {
  if (a.Lq < 1 || a.Lk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return bwd_plan<40, DKV>(a, B, rows, threads, s);
    case 80:
      return bwd_plan<80, DKV>(a, B, rows, threads, s);
    case 160:
      return bwd_plan<160, DKV>(a, B, rows, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// 16-byte copies and stores: every pointer 16-byte aligned, every stride a
// multiple of 4 floats.
bool all_vec(const void* const* ptrs, int np, const long long* st, int ns) {
  bool vec = true;
  for (int i = 0; i < np; ++i) vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  for (int i = 0; i < ns; ++i) vec = vec && st[i] % 4 == 0;
  return vec;
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

// `rows`, `threads` and `split` are the plan's query rows and threads a
// CTA and slices of the key tiles (ops/flash_attention.py
// bwd_fp32_launch_plan): 1, 2 or 4 warps of 32 rows (16 at d160), a split
// of 1 to the key tiles; any other plan is refused. A split above 1 takes
// `ws`, fp32 [split, B, Lq, H D], 16-byte aligned, and a packed, contiguous
// dq. `strides`
// holds the batch and row strides of q, k, v, dO and dq (10 values). `bias`
// may be null.
extern "C" int flash_attn_fp32_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* bias, void* dq, int B, int H, int Lq,
                                      int Lk, int D, int rows, int threads, int split,
                                      const long long* strides, float sc_log2, float scale,
                                      void* ws, void* stream) {
  const long long* st = strides;
  const void* ptrs[] = {q, k, v, dout, dq};
  const BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<const float*>(bias), static_cast<float*>(dq), nullptr, nullptr,
                  H, Lq, Lk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                  st[9], 0, 0, sc_log2, scale, all_vec(ptrs, 5, st, 10) ? 1 : 0, split,
                  static_cast<float*>(ws)};
  return bwd_dims<false>(a, B, D, rows, threads, stream);
}

// `keys`, `threads` and `split` are the plan's keys and threads a CTA and
// slices of the query tiles (bwd_fp32_launch_plan): 1, 2 or 4 warps of 32
// keys (16 at d80, 8 at d160), a split of 1 to the query tiles; any other
// plan is refused. A split above 1 takes `ws`, fp32 [split, 2 B Lk H D (+ B
// H Lk rounded up to a multiple of 4, with dbias)], 16-byte aligned, and
// packed, contiguous dk and dv. `strides` holds the
// batch and row strides of q, k, v, dO, dk and dv (12 values). `bias` and
// `dbias` may be null.
extern "C" int flash_attn_fp32_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* bias, void* dk, void* dv, void* dbias,
                                       int B, int H, int Lq, int Lk, int D, int keys,
                                       int threads, int split, const long long* strides,
                                       float sc_log2, float scale, void* ws, void* stream) {
  const long long* st = strides;
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  const BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<const float*>(bias), static_cast<float*>(dk),
                  static_cast<float*>(dv), static_cast<float*>(dbias), H, Lq, Lk, st[0], st[1],
                  st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
                  sc_log2, scale, all_vec(ptrs, 6, st, 12) ? 1 : 0, split,
                  static_cast<float*>(ws)};
  return bwd_dims<true>(a, B, D, keys, threads, stream);
}
