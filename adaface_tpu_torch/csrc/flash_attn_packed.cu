// Packed-layout flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU forward kernels of the JAX package, which all compute one
// function and differ only in their TPU tiling (lane transposes, one or many
// K blocks, max-free or guarded recurrence):
//   K1  adaface_tpu/ops/flash_attention.py:578  _flash_kernel_heads_pvt
//   K2  adaface_tpu/ops/flash_attention.py:639  _flash_kernel_heads_pvt2
//   K4  adaface_tpu/ops/flash_attention.py:544  _flash_kernel_heads_short
//   K5  adaface_tpu/ops/flash_attention.py:467  _flash_kernel_heads
// reached through _flash_forward_blc / flash_attention_blc, and
//   K6  adaface_tpu/ops/flash_attention.py:59   _flash_kernel
//   K7  adaface_tpu/ops/flash_attention.py:129  _flash_row_kernel
// of the [B, H, L, D] entry flash_attention, which the caller folds into
// one-head [B*H, L, D] calls; and, when asked for the row statistics, the
// backward's recompute pass
//   K3a adaface_tpu/ops/flash_attention.py:236  _row_lse_kernel
// whose lse2 = m + log2(l) this kernel already holds at its end.
//
// Function, for each (batch b, head h, query row i):
//   s_j = (q_i . k_j) * scale * log2(e)
//   if a key bias is given: s_j = max(s_j + bias[b, j] * log2(e), -100)
//   o_i = sum_j 2^s_j v_j / sum_j 2^s_j
//   lse[b, h, i] = log2(sum_j 2^s_j)            (only when lse != nullptr)
// q, k, v are [B, L, H*D] views (each with its own batch and row stride, so
// the three thirds of a fused [B, L, 3*H*D] projection work without a copy);
// head h is the column panel [h*D, (h+1)*D). The output is packed [B, Lq, H*D]
// bf16, lse fp32 [B, H, Lq]. bf16 in, fp32 accumulation.
//
// K1's two arithmetic arms (`flags`, ADAFACE_FLASH_EXP_BF16 and
// ADAFACE_FLASH_MXU_SUM in the JAX package) change the function:
//   FLAG_EXP_BF16: p_j = bf16(2^bf16(s_j)), and the denominator sums those
//                  bf16 values in fp32;
//   FLAG_MXU_SUM:  the denominator sums bf16(p_j) (the TPU adds a ones row to
//                  V^T, so l comes out of the same bf16 product as o).
// bf16 rounding does not commute with a shift by a non-integer running
// maximum, so under a flag the shift m is an integer (the running maximum
// rounded up): bf16(2^(x - m)) = bf16(2^x) * 2^-m exactly, and every
// rescale is an exact power of two. The lse written under a flag is the
// default function's (K3a computes it from fp32 scores), from a second fp32
// sum kept beside the flagged one.
//
// The TPU kernels use a max-free softmax (LN-bounded scores cannot overflow
// exp2). This kernel keeps a running row maximum instead (the online
// softmax): the same function, since softmax is shift-invariant, and safe for
// inputs that are not LN-bounded. A fully masked row (all bias -1e30) floors
// every score at -100 and comes out as uniform attention, as in the TPU code.
//
// What bounds it on an H100: at the UNet shapes (L 256..4096, d 40/80/160)
// the work is 4*B*H*Lq*Lk*Dp tensor-core flops plus B*H*Lq*Lk exp2 on the
// special-function units; the exp2 count is the larger of the two bounds at
// d=40 (16 exp2 per clock per SM against 1024 bf16 FMA per clock per SM),
// and the bytes (q, k, v, o read or written once) are two orders smaller.
// So the design keeps the [Lq, Lk] scores out of device memory entirely:
//   - grid (ceil(Lq/64), H, B); 4 warps, each owning 16 query rows;
//   - the Q tile [64, Dp] and double-buffered K/V tiles [64, Dp] live in
//     shared memory (Dp = D rounded up to 16, zero-padded), fed by cp.async
//     so the next K/V tile loads while the current one is used;
//   - S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 with fp32
//     accumulators held in registers; P never leaves registers (the S
//     accumulator layout is the A-operand layout of the P V product).
// Later work (wgmma, TMA, exp2 emulation on the FMA pipe) is for a PR that
// makes it fast.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = TILE;  // query rows per block
constexpr int BK = TILE;  // keys per K/V tile
constexpr int FLAG_EXP_BF16 = 1;
constexpr int FLAG_MXU_SUM = 2;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 2^n for an integer-valued n <= 0, exact; 0 below the normal range.
__device__ __forceinline__ float exp2_int(float n) {
  const int e = (int)n;
  return e < -126 ? 0.0f : __int_as_float((e + 127) << 23);
}

template <int D, int FLAGS>
__global__ void __launch_bounds__(THREADS)
flash_fwd_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        bf16* __restrict__ o, float* __restrict__ lse, int Lq, int Lk,
                        long long sq_b, long long sq_l, long long sk_b,
                        long long sk_l, long long sv_b, long long sv_l,
                        long long so_b, long long so_l, float sc_log2) {
  constexpr int DP = (D + 15) / 16 * 16;  // MMA depth granule
  constexpr int LD = DP + 8;              // +16 bytes per row against bank conflicts
  constexpr int NT_D = DP / 8;            // n-tiles of the output panel
  constexpr int NT_K = BK / 8;            // n-tiles of the score tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                        // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                    // [2][BK][LD]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row group within the mma fragment
  const int t = lane & 3;   // thread within the group

  const bf16* qp = q + b * sq_b + (long long)h * D;
  const bf16* kp = k + b * sk_b + (long long)h * D;
  const bf16* vp = v + b * sv_b + (long long)h * D;
  const float* bp = bias == nullptr ? nullptr : bias + (long long)b * Lk;

  zero_pad_columns<D, DP, LD>(Qs, 5, tid);  // Q and both K/V buffers

  load_tile<D, LD>(Qs, qp, sq_l, q0, Lq, tid);
  load_tile<D, LD>(Ks, kp, sk_l, 0, Lk, tid);
  load_tile<D, LD>(Vs, vp, sv_l, 0, Lk, tid);
  cp_async_commit();

  float acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.0f, 0.0f};            // this thread's partial row sums
  float l_lse[2] = {0.0f, 0.0f};            // under a flag: the fp32 sums for lse
  const bool flag_lse = FLAGS != 0 && lse != nullptr;

  const int wrow = warp * 16;
  const int nkt = (Lk + BK - 1) / BK;

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) {
      load_tile<D, LD>(Ks + (buf ^ 1) * BK * LD, kp, sk_l, (kt + 1) * BK, Lk, tid);
      load_tile<D, LD>(Vs + (buf ^ 1) * BK * LD, vp, sv_l, (kt + 1) * BK, Lk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bf16* Kt = Ks + buf * BK * LD;
    const bf16* Vt = Vs + buf * BK * LD;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT_K][4];
#pragma unroll
    for (int n = 0; n < NT_K; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    mma_rows_by_tile<DP, LD>(s, Qs, wrow, Kt, g, t);

    // log2-domain scores, bias and floor, ragged-edge keys excluded.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < NT_K; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * BK + n * 8 + t * 2 + (e & 1);
        float x = s[n][e] * sc_log2;
        if (bp != nullptr)
          x = fmaxf(x + (key < Lk ? bp[key] : 0.0f) * LOG2E, SCORE_FLOOR);
        if (key >= Lk) x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float msub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      float corr;
      if constexpr (FLAGS == 0) {
        msub[r] = mx[r] == -INFINITY ? 0.0f : mx[r];
        corr = exp2f(m_run[r] - msub[r]);
        m_run[r] = mx[r];
      } else {  // an integer shift, so that every rescale is exact
        msub[r] = mx[r] == -INFINITY ? 0.0f : ceilf(mx[r]);
        corr = m_run[r] == -INFINITY ? 0.0f : exp2_int(m_run[r] - msub[r]);
        m_run[r] = mx[r] == -INFINITY ? -INFINITY : msub[r];
        l_lse[r] *= corr;
      }
      l_run[r] *= corr;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // P = 2^(S - m), packed straight into A fragments of the P V product.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < NT_K; ++n) {
      float p[4], lp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float m = msub[e >> 1];
        if constexpr ((FLAGS & FLAG_EXP_BF16) != 0) {
          p[e] = round_bf16(exp2f(round_bf16(x) - m));
        } else {
          p[e] = exp2f(x - m);
        }
        lp[e] = (FLAGS & FLAG_MXU_SUM) != 0 ? round_bf16(p[e]) : p[e];
        if (flag_lse) l_lse[e >> 1] += exp2f(x - m);
      }
      l_run[0] += lp[0] + lp[1];
      l_run[1] += lp[2] + lp[3];
      pa[n >> 1][(n & 1) * 2] = pack_bf16x2(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
    }

    // O += P V.
    mma_p_by_tile<DP, LD>(acc, pa, Vt, lane);
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  float inv[2];
  const int row0 = q0 + wrow + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / l;
    if (lse != nullptr) {
      float ls = flag_lse ? l_lse[r] : l;
      if (flag_lse) {
        ls += __shfl_xor_sync(0xffffffffu, ls, 1);
        ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      }
      if (t == 0 && row0 + 8 * r < Lq)
        lse[((long long)b * gridDim.y + h) * Lq + row0 + 8 * r] = m_run[r] + log2f(ls);
    }
  }
  store_rows<D, DP>(o + b * so_b + (long long)h * D, so_l, acc, inv[0], inv[1], row0,
                    Lq, t);
}

template <int D, int FLAGS>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o,
           void* lse, int B, int H, int Lq, int Lk, const long long* st, float sc_log2,
           cudaStream_t stream) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LD = DP + 8;
  const size_t smem = (size_t)(BQ + 4 * BK) * LD * sizeof(bf16);
  static const cudaError_t attr_err = allow_smem(flash_fwd_packed_kernel<D, FLAGS>, smem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_packed_kernel<D, FLAGS><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), Lq, Lk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], sc_log2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_flags(int flags, const void* q, const void* k, const void* v,
                 const void* bias, void* o, void* lse, int B, int H, int Lq, int Lk,
                 const long long* st, float sc_log2, cudaStream_t s) {
  switch (flags) {
    case 0:
      return launch<D, 0>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, sc_log2, s);
    case FLAG_EXP_BF16:
      return launch<D, FLAG_EXP_BF16>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, sc_log2, s);
    case FLAG_MXU_SUM:
      return launch<D, FLAG_MXU_SUM>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, sc_log2, s);
    case FLAG_EXP_BF16 | FLAG_MXU_SUM:
      return launch<D, FLAG_EXP_BF16 | FLAG_MXU_SUM>(q, k, v, bias, o, lse, B, H, Lq, Lk,
                                                     st, sc_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Built for the UNet's head dims 40, 80 and 160, with every flag. `strides` holds the batch and row strides, in elements, of
// q, k, v and o (8 values). `bias` and `lse` may be null. `flags` is a mask
// of FLAG_EXP_BF16 (1) and FLAG_MXU_SUM (2). Returns a cudaError_t value (0 on
// success).
extern "C" int flash_attn_packed_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, void* o, void* lse, int B,
                                     int H, int Lq, int Lk, int D, int flags,
                                     const long long* strides, float sc_log2,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return launch_flags<40>(flags, q, k, v, bias, o, lse, B, H, Lq, Lk, strides,
                              sc_log2, s);
    case 80:
      return launch_flags<80>(flags, q, k, v, bias, o, lse, B, H, Lq, Lk, strides,
                              sc_log2, s);
    case 160:
      return launch_flags<160>(flags, q, k, v, bias, o, lse, B, H, Lq, Lk, strides,
                               sc_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
