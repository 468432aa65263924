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
// Design (simple, a CTA of 256 threads per 64-row block of one head):
//   - the two operands of a score product sit transposed in shared memory
//     ([D][68]: 16-byte aligned float4 rows, the 64 rows/keys along the
//     fast axis), and each thread computes a 4x4 block of the 64x64 score
//     tile from float4 reads (16 FFMA per 8 values read);
//   - row statistics reduce over the 16 lanes of a half-warp that share a
//     row block (xor shuffles);
//   - the second product (p V, ds K, p^T dO, ds^T Q) gives each thread one
//     row and every fourth of the D columns, accumulated in registers;
//   - launch bounds of one CTA an SM leave ptxas the registers it wants
//     (with the default bound it held the d40 dq to 64 and spilled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows (forward, dq) or keys (dk/dv) a CTA owns
constexpr int BK = 64;   // rows of the streamed tile
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

// rows [r0, r0 + 64) into t[64][D] (row-major); zeros past `len`.
template <int D>
__device__ __forceinline__ void load_rows(float* t, const float* __restrict__ src,
                                          long long sl, int r0, int len) {
  for (int i = threadIdx.x; i < BK * D; i += NT) {
    const int r = i / D, c = i - r * D;
    t[i] = (r0 + r < len) ? src[(long long)(r0 + r) * sl + c] : 0.f;
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

// reductions over the 16 lanes (one row block) of a half-warp
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
struct Fwd {
  static constexpr int QT = 0, KT = QT + D * LD, V = KT + D * LD, P = V + BK * D,
                       BIAS = P + BQ * LD, M = BIAS + BK, ALPHA = M + BQ, L = ALPHA + BQ,
                       L2 = L + BQ, FLOATS = L2 + BQ;
  static constexpr size_t SMEM = FLOATS * sizeof(float);
};

template <int D, bool EXPBF16, bool BIAS>
__global__ void __launch_bounds__(NT, 1) flash_fp32_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ o, float* __restrict__ lse, int H,
    int Lq, int Lk, long long sbq, long long slq,
    long long sbk, long long slk, long long sbv, long long slv, long long sbo, long long slo,
    float sc_log2) {
  using S = Fwd<D>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *qT = sm + S::QT, *kT = sm + S::KT, *vs = sm + S::V, *ps = sm + S::P,
        *bs = sm + S::BIAS, *rm = sm + S::M, *ra = sm + S::ALPHA, *rl = sm + S::L,
        *rl2 = sm + S::L2;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int orow = tid >> 2, oc = tid & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * sbq + h * D;
  const float* kb = k + b * sbk + h * D;
  const float* vb = v + b * sbv + h * D;
  load_t<D>(qT, qb, slq, q0, Lq);
  if (tid < BQ) {
    rm[tid] = -INFINITY;
    rl[tid] = 0.f;
    rl2[tid] = 0.f;
  }
  float acc_o[D / 4];
#pragma unroll
  for (int jj = 0; jj < D / 4; ++jj) acc_o[jj] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // the last tile's p V is done with vs, ps, ra
    load_t<D>(kT, kb, slk, k0, Lk);
    load_rows<D>(vs, vb, slv, k0, Lk);
    if (BIAS && tid < BK)
      bs[tid] = (k0 + tid < Lk) ? bias[(long long)b * Lk + k0 + tid] * LOG2E : 0.f;
    __syncthreads();
    float acc[4][4] = {};
    block_4x4<D>(acc, qT, kT, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float s[4], sr[4];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        float x = acc[i][j] * sc_log2;
        if (BIAS) x = fmaxf(x + bs[c], SCORE_FLOOR);
        if (k0 + c >= Lk) x = -INFINITY;
        s[j] = x;
        sr[j] = EXPBF16 ? bf16_round(x) : x;
        mt = fmaxf(mt, sr[j]);
      }
      mt = half_max(mt);
      const float m_old = rm[r];
      float m_new = fmaxf(m_old, EXPBF16 ? ceilf(mt) : mt);
      float psum = 0.f, psum2 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2f(sr[j] - m_new);
        if (EXPBF16) {
          p = bf16_round(p);
          psum2 += exp2f(s[j] - m_new);
        }
        psum += p;
        ps[r * LD + tx * 4 + j] = p;
      }
      psum = half_sum(psum);
      if (EXPBF16) psum2 = half_sum(psum2);
      if (tx == 0) {
        const float alpha = exp2f(m_old - m_new);
        rl[r] = rl[r] * alpha + psum;
        if (EXPBF16) rl2[r] = rl2[r] * alpha + psum2;
        rm[r] = m_new;
        ra[r] = alpha;
      }
    }
    __syncthreads();
    const float alpha = ra[orow];
#pragma unroll
    for (int jj = 0; jj < D / 4; ++jj) acc_o[jj] *= alpha;
    const float* prow = ps + orow * LD;
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float p = prow[j];
      const float* vr = vs + j * D + oc;
#pragma unroll
      for (int jj = 0; jj < D / 4; ++jj) acc_o[jj] = fmaf(p, vr[4 * jj], acc_o[jj]);
    }
  }
  __syncthreads();
  const int r = q0 + orow;
  if (r < Lq) {
    const float inv = 1.f / rl[orow];
    float* ob = o + b * sbo + (long long)r * slo + h * D + oc;
#pragma unroll
    for (int jj = 0; jj < D / 4; ++jj) ob[4 * jj] = acc_o[jj] * inv;
    if (lse != nullptr && oc == 0)
      lse[((long long)b * H + h) * Lq + r] = rm[orow] + log2f(EXPBF16 ? rl2[orow] : rl[orow]);
  }
}

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

template <int D, bool EXPBF16, bool BIAS>
int fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
        int B, int H, int Lq, int Lk, const long long* st, float sc_log2, cudaStream_t s) {
  constexpr size_t smem = Fwd<D>::SMEM;
  static const cudaError_t attr = allow_smem(flash_fp32_fwd_kernel<D, EXPBF16, BIAS>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fp32_fwd_kernel<D, EXPBF16, BIAS><<<grid, NT, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias), static_cast<float*>(o),
      static_cast<float*>(lse), H, Lq, Lk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], sc_log2);
  return (int)cudaGetLastError();
}

template <int D, bool EXPBF16>
int fwd_bias(const void* q, const void* k, const void* v, const void* bias, void* o,
             void* lse, int B, int H, int Lq, int Lk, const long long* st, float sc_log2,
             cudaStream_t s) {
  return bias != nullptr
             ? fwd<D, EXPBF16, true>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, sc_log2, s)
             : fwd<D, EXPBF16, false>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, sc_log2, s);
}

template <int D>
int fwd_flags(int flags, const void* q, const void* k, const void* v, const void* bias,
              void* o, void* lse, int B, int H, int Lq, int Lk, const long long* st,
              float sc_log2, cudaStream_t s) {
  return (flags & FLAG_EXP_BF16)
             ? fwd_bias<D, true>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, sc_log2, s)
             : fwd_bias<D, false>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, sc_log2, s);
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

// Built for the UNet's head dims 40, 80 and 160. `strides` holds the batch
// and row strides, in elements, of q, k, v and o (8 values). `bias` and `lse`
// may be null. `flags` is a mask of FLAG_EXP_BF16 (1) and FLAG_MXU_SUM (2);
// any other bit is refused. Returns a cudaError_t value (0 on success).
extern "C" int flash_attn_fp32_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* o, void* lse, int B, int H, int Lq,
                                   int Lk, int D, int flags, const long long* strides,
                                   float sc_log2, void* stream) {
  if (flags & ~(FLAG_EXP_BF16 | FLAG_MXU_SUM)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return fwd_flags<40>(flags, q, k, v, bias, o, lse, B, H, Lq, Lk, strides, sc_log2, s);
    case 80:
      return fwd_flags<80>(flags, q, k, v, bias, o, lse, B, H, Lq, Lk, strides, sc_log2, s);
    case 160:
      return fwd_flags<160>(flags, q, k, v, bias, o, lse, B, H, Lq, Lk, strides, sc_log2, s);
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
