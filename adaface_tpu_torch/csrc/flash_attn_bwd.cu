// Packed-layout flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU backward kernels of the JAX package
// (adaface_tpu/ops/flash_attention.py:296 _flash_backward, the backward of
// both the packed entry and the [B, H, L, D] entry, which the caller folds
// into one-head [B*H, L, D] calls):
//   K3b :252 _bwd_dq_kernel    dq = (p o (dO V^T - delta)) K * scale
//   K3c :272 _bwd_dkv_kernel   dv = p^T dO, dk = (p o (dp - delta))^T Q * scale,
//                              dbias_h = sum_q p o (dp - delta)
// (K3a, the row log2-sum-exp, is the forward kernel's second output.)
//
// With the forward's log2-domain scores
//   s_ij = max((q_i . k_j) * scale * log2(e) + bias_j * log2(e), -100)
// (no bias: no floor), p_ij = 2^(s_ij - lse_i) is the softmax, and
// ds_ij = p_ij * (dp_ij - delta_i), dp = dO V^T, delta_i = dO_i . o_i (fp32,
// computed outside), is the gradient with respect to the natural-log score
// (q . k) * scale + bias. As in the TPU kernels, ds is not zeroed where the
// floor clamped a score, so a fully masked row has a nonzero dbias.
// Roundings follow the TPU kernels: ds is rounded to bf16 for ds K and
// ds^T Q, p to bf16 for p^T dO; dbias sums the fp32 ds.
//
// Layout: q, k, v, dO, dq, dk, dv are [B, L, H*D] views with their own batch
// and row strides (head h is the column panel [h*D, (h+1)*D)); lse and delta
// fp32 [B, H, Lq]; bias fp32 [B, Lk]; dbias_h fp32 [B, H, Lk] (summed over
// heads by the caller). bf16 in and out, fp32 accumulation.
//
// What bounds it on an H100: dq does 6*B*H*Lq*Lk*Dp tensor-core flops
// (S, dP, dQ), dk/dv 8*B*H*Lq*Lk*Dp (S, dP, dV, dK), each B*H*Lq*Lk exp2; the
// bytes (inputs and outputs once) are two orders smaller. So, as in the
// forward, no [Lq, Lk] slab touches device memory:
//   dq kernel: grid (ceil(Lq/64), H, B); 4 warps of 16 query rows; Q and dO
//     tiles resident, K/V tiles double-buffered by cp.async; S, dP and the
//     dQ accumulator in registers, ds packed straight into A fragments.
//   dk/dv kernel: grid (ceil(Lk/64), H, B); 4 warps of 16 keys; K and V tiles
//     resident, Q/dO tiles double-buffered; the transposed products S^T =
//     K Q^T and dP^T = V dO^T keep keys as mma rows, so each block owns its
//     key rows of dk, dv and dbias and no atomics are needed. At d = 160 the
//     dk and dv accumulators (2 x 80 fp32 registers per thread) would not
//     fit beside the score tiles, so the block streams Q twice: once for dv,
//     once for dk and dbias (recomputing S^T, one extra Q K^T).
// Register and spill counts per head dim come from nvcc -Xptxas=-v.

#include "flash_common.cuh"

namespace {

using namespace flash;

// log2-domain score of one element: scale, bias and floor as the forward.
__device__ __forceinline__ float log2_score(float acc, float sc_log2, const float* bp,
                                            int key, int Lk) {
  float x = acc * sc_log2;
  if (bp != nullptr) x = fmaxf(x + (key < Lk ? bp[key] : 0.0f) * LOG2E, SCORE_FLOOR);
  return x;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ bias, bf16* __restrict__ dq, int Lq,
                    int Lk, long long sq_b, long long sq_l, long long sk_b,
                    long long sk_l, long long sv_b, long long sv_l, long long sd_b,
                    long long sd_l, long long sdq_b, long long sdq_l, float sc_log2,
                    float scale) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LD = DP + 8;
  constexpr int NT_D = DP / 8;
  constexpr int NT_K = TILE / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Ds = Qs + TILE * LD;                      // [64][LD] dO
  bf16* Ks = Ds + TILE * LD;                      // [2][64][LD]
  bf16* Vs = Ks + 2 * TILE * LD;                  // [2][64][LD]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int q0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16;

  const bf16* qp = q + b * sq_b + (long long)h * D;
  const bf16* kp = k + b * sk_b + (long long)h * D;
  const bf16* vp = v + b * sv_b + (long long)h * D;
  const bf16* dp_ = dout + b * sd_b + (long long)h * D;
  const float* bp = bias == nullptr ? nullptr : bias + (long long)b * Lk;
  const long long stat0 = ((long long)b * H + h) * Lq;

  zero_pad_columns<D, DP, LD>(Qs, 6, tid);  // Q, dO and both K/V buffers

  load_tile<D, LD>(Qs, qp, sq_l, q0, Lq, tid);
  load_tile<D, LD>(Ds, dp_, sd_l, q0, Lq, tid);
  load_tile<D, LD>(Ks, kp, sk_l, 0, Lk, tid);
  load_tile<D, LD>(Vs, vp, sv_l, 0, Lk, tid);
  cp_async_commit();

  // row statistics of this thread's rows g and g + 8
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    row_lse[r] = row < Lq ? lse[stat0 + row] : 0.0f;
    row_delta[r] = row < Lq ? delta[stat0 + row] : 0.0f;
  }

  float acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int nkt = (Lk + TILE - 1) / TILE;
  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) {
      load_tile<D, LD>(Ks + (buf ^ 1) * TILE * LD, kp, sk_l, (kt + 1) * TILE, Lk, tid);
      load_tile<D, LD>(Vs + (buf ^ 1) * TILE * LD, vp, sv_l, (kt + 1) * TILE, Lk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * TILE * LD;
    const bf16* Vt = Vs + buf * TILE * LD;

    float s[NT_K][4], dpt[NT_K][4];
#pragma unroll
    for (int n = 0; n < NT_K; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.0f;
    }
    mma_rows_by_tile<DP, LD>(s, Qs, wrow, Kt, g, t);    // S = Q K^T
    mma_rows_by_tile<DP, LD>(dpt, Ds, wrow, Vt, g, t);  // dP = dO V^T

    // ds = p * (dp - delta), rounded to bf16 into A fragments of ds K.
    uint32_t da[TILE / 16][4];
#pragma unroll
    for (int n = 0; n < NT_K; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * TILE + n * 8 + t * 2 + (e & 1);
        const int r = e >> 1;
        const float p = key < Lk
            ? exp2f(log2_score(s[n][e], sc_log2, bp, key, Lk) - row_lse[r]) : 0.0f;
        ds[e] = p * (dpt[n][e] - row_delta[r]);
      }
      da[n >> 1][(n & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
      da[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
    }
    mma_p_by_tile<DP, LD>(acc, da, Kt, lane);  // dQ += ds K
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  store_rows<D, DP>(dq + b * sdq_b + (long long)h * D, sdq_l, acc, scale, scale,
                    q0 + wrow + g, Lq, t);
}

// One pass of the dk/dv kernel over every query tile: accumulates dv
// (DO_DV) and/or dk and dbias (DO_DK) for this block's 64 keys, then stores
// them. Ks/Vs hold the block's key and value tiles; Qs/Ds are the
// double-buffered query and dO tiles.
template <int D, bool DO_DV, bool DO_DK>
__device__ __forceinline__ void dkv_pass(
    const bf16* Ks, const bf16* Vs, bf16* Qs, bf16* Ds, const bf16* qp,
    const bf16* dp_, const float* lse, const float* delta, float row_bias_l2[2],
    bool have_bias, bf16* dkp, bf16* dvp, float* dbp, int Lq, int Lk, int k0,
    long long sq_l, long long sd_l, long long sdk_l, long long sdv_l, float sc_log2,
    float scale, int tid) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LD = DP + 8;
  constexpr int NT_D = DP / 8;
  constexpr int NT_Q = TILE / 8;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16;

  load_tile<D, LD>(Qs, qp, sq_l, 0, Lq, tid);
  load_tile<D, LD>(Ds, dp_, sd_l, 0, Lq, tid);
  cp_async_commit();

  float acc_v[DO_DV ? NT_D : 1][4];
  float acc_k[DO_DK ? NT_D : 1][4];
#pragma unroll
  for (int n = 0; n < (DO_DV ? NT_D : 1); ++n)
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.0f;
#pragma unroll
  for (int n = 0; n < (DO_DK ? NT_D : 1); ++n)
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.0f;
  float db[2] = {0.0f, 0.0f};  // this thread's partial dbias of keys g, g + 8

  const int nqt = (Lq + TILE - 1) / TILE;
  for (int qt = 0; qt < nqt; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < nqt) {
      load_tile<D, LD>(Qs + (buf ^ 1) * TILE * LD, qp, sq_l, (qt + 1) * TILE, Lq, tid);
      load_tile<D, LD>(Ds + (buf ^ 1) * TILE * LD, dp_, sd_l, (qt + 1) * TILE, Lq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + buf * TILE * LD;
    const bf16* Dt = Ds + buf * TILE * LD;

    // S^T = K Q^T: rows are this warp's 16 keys, columns the tile's queries.
    float st[NT_Q][4];
#pragma unroll
    for (int n = 0; n < NT_Q; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.0f;
    mma_rows_by_tile<DP, LD>(st, Ks, wrow, Qt, g, t);

    // p^T = 2^(s - lse[query]); queries past Lq contribute nothing.
    float p[NT_Q][4];
    float col_delta[NT_Q][2];
#pragma unroll
    for (int n = 0; n < NT_Q; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int query = qt * TILE + n * 8 + t * 2 + c;
        const bool valid = query < Lq;
        const float l = valid ? lse[query] : 0.0f;
        col_delta[n][c] = valid ? delta[query] : 0.0f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = st[n][2 * r + c] * sc_log2;
          if (have_bias) x = fmaxf(x + row_bias_l2[r], SCORE_FLOOR);
          p[n][2 * r + c] = valid ? exp2f(x - l) : 0.0f;
        }
      }
    }

    if constexpr (DO_DV) {  // dV += p^T dO, p rounded to bf16
      uint32_t pa[TILE / 16][4];
#pragma unroll
      for (int n = 0; n < NT_Q; ++n) {
        pa[n >> 1][(n & 1) * 2] = pack_bf16x2(p[n][0], p[n][1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(p[n][2], p[n][3]);
      }
      mma_p_by_tile<DP, LD>(acc_v, pa, Dt, lane);
    }

    if constexpr (DO_DK) {
      // dP^T = V dO^T, ds^T = p^T (dP^T - delta[query]); dK += ds^T Q.
      float dpt[NT_Q][4];
#pragma unroll
      for (int n = 0; n < NT_Q; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.0f;
      mma_rows_by_tile<DP, LD>(dpt, Vs, wrow, Dt, g, t);
      uint32_t da[TILE / 16][4];
#pragma unroll
      for (int n = 0; n < NT_Q; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[e] = p[n][e] * (dpt[n][e] - col_delta[n][e & 1]);
          db[e >> 1] += ds[e];
        }
        da[n >> 1][(n & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
        da[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
      }
      mma_p_by_tile<DP, LD>(acc_k, da, Qt, lane);
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  const int row0 = k0 + wrow + g;
  if constexpr (DO_DV) store_rows<D, DP>(dvp, sdv_l, acc_v, 1.0f, 1.0f, row0, Lk, t);
  if constexpr (DO_DK) {
    store_rows<D, DP>(dkp, sdk_l, acc_k, scale, scale, row0, Lk, t);
    if (dbp != nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = db[r];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (t == 0 && row0 + 8 * r < Lk) dbp[row0 + 8 * r] = x;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ bias, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float* __restrict__ dbias, int Lq, int Lk,
                     long long sq_b, long long sq_l, long long sk_b, long long sk_l,
                     long long sv_b, long long sv_l, long long sd_b, long long sd_l,
                     long long sdk_b, long long sdk_l, long long sdv_b,
                     long long sdv_l, float sc_log2, float scale) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LD = DP + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Vs = Ks + TILE * LD;                      // [64][LD]
  bf16* Qs = Vs + TILE * LD;                      // [2][64][LD]
  bf16* Ds = Qs + 2 * TILE * LD;                  // [2][64][LD] dO

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int k0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int g = (tid & 31) >> 2;
  const int wrow = (tid >> 5) * 16;

  const bf16* qp = q + b * sq_b + (long long)h * D;
  const bf16* kp = k + b * sk_b + (long long)h * D;
  const bf16* vp = v + b * sv_b + (long long)h * D;
  const bf16* dp_ = dout + b * sd_b + (long long)h * D;
  const long long stat0 = ((long long)b * H + h) * Lq;

  zero_pad_columns<D, DP, LD>(Ks, 6, tid);  // K, V and both Q/dO buffers
  load_tile<D, LD>(Ks, kp, sk_l, k0, Lk, tid);
  load_tile<D, LD>(Vs, vp, sv_l, k0, Lk, tid);
  cp_async_commit();

  // bias * log2(e) of this thread's keys g and g + 8
  float row_bias_l2[2] = {0.0f, 0.0f};
  if (bias != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + wrow + g + 8 * r;
      row_bias_l2[r] = key < Lk ? bias[(long long)b * Lk + key] * LOG2E : 0.0f;
    }
  }

  bf16* dkp = dk + b * sdk_b + (long long)h * D;
  bf16* dvp = dv + b * sdv_b + (long long)h * D;
  float* dbp = dbias == nullptr ? nullptr : dbias + ((long long)b * H + h) * Lk;
  const float* lp = lse + stat0;
  const float* dlp = delta + stat0;
  const bool hb = bias != nullptr;
  if constexpr (D <= 80) {
    dkv_pass<D, true, true>(Ks, Vs, Qs, Ds, qp, dp_, lp, dlp, row_bias_l2, hb, dkp,
                            dvp, dbp, Lq, Lk, k0, sq_l, sd_l, sdk_l, sdv_l, sc_log2,
                            scale, tid);
  } else {
    dkv_pass<D, true, false>(Ks, Vs, Qs, Ds, qp, dp_, lp, dlp, row_bias_l2, hb, dkp,
                             dvp, dbp, Lq, Lk, k0, sq_l, sd_l, sdk_l, sdv_l, sc_log2,
                             scale, tid);
    dkv_pass<D, false, true>(Ks, Vs, Qs, Ds, qp, dp_, lp, dlp, row_bias_l2, hb, dkp,
                             dvp, dbp, Lq, Lk, k0, sq_l, sd_l, sdk_l, sdv_l, sc_log2,
                             scale, tid);
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* bias, void* dq, int B,
              int H, int Lq, int Lk, const long long* st, float sc_log2, float scale,
              cudaStream_t stream) {
  constexpr int LD = (D + 15) / 16 * 16 + 8;
  const size_t smem = (size_t)6 * TILE * LD * sizeof(bf16);
  static const cudaError_t attr_err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const dim3 grid((Lq + TILE - 1) / TILE, H, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<bf16*>(dq), Lq, Lk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], sc_log2, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* bias, void* dk,
               void* dv, void* dbias, int B, int H, int Lq, int Lk, const long long* st,
               float sc_log2, float scale, cudaStream_t stream) {
  constexpr int LD = (D + 15) / 16 * 16 + 8;
  const size_t smem = (size_t)6 * TILE * LD * sizeof(bf16);
  static const cudaError_t attr_err = allow_smem(flash_bwd_dkv_kernel<D>, smem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const dim3 grid((Lk + TILE - 1) / TILE, H, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dbias), Lq, Lk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], sc_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Built for the UNet's head dims 40, 80 and 160. `strides` holds the batch
// and row strides, in elements, of q, k, v, dO, dq (10 values). `bias` may be
// null. Returns a cudaError_t value (0 on success).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* bias, void* dq, int B, int H, int Lq,
                                 int Lk, int D, const long long* strides,
                                 float sc_log2, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return launch_dq<40>(q, k, v, dout, lse, delta, bias, dq, B, H, Lq, Lk, strides,
                           sc_log2, scale, s);
    case 80:
      return launch_dq<80>(q, k, v, dout, lse, delta, bias, dq, B, H, Lq, Lk, strides,
                           sc_log2, scale, s);
    case 160:
      return launch_dq<160>(q, k, v, dout, lse, delta, bias, dq, B, H, Lq, Lk, strides,
                            sc_log2, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// `strides` holds the batch and row strides of q, k, v, dO, dk, dv (12
// values). `bias` and `dbias` may be null.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  const void* bias, void* dk, void* dv, void* dbias,
                                  int B, int H, int Lq, int Lk, int D,
                                  const long long* strides, float sc_log2, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return launch_dkv<40>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq,
                            Lk, strides, sc_log2, scale, s);
    case 80:
      return launch_dkv<80>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq,
                            Lk, strides, sc_log2, scale, s);
    case 160:
      return launch_dkv<160>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq,
                             Lk, strides, sc_log2, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
