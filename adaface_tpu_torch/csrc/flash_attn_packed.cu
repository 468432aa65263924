// Packed-layout flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   K1  adaface_tpu/ops/flash_attention.py:578  _flash_kernel_heads_pvt
//   K4  adaface_tpu/ops/flash_attention.py:544  _flash_kernel_heads_short
// both reached through _flash_forward_blc / flash_attention_blc; and, when
// asked for the row statistics, the backward's recompute pass
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

template <int D>
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
      msub[r] = mx[r] == -INFINITY ? 0.0f : mx[r];
      const float corr = exp2f(m_run[r] - msub[r]);
      m_run[r] = mx[r];
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
      const float p0 = exp2f(s[n][0] - msub[0]);
      const float p1 = exp2f(s[n][1] - msub[0]);
      const float p2 = exp2f(s[n][2] - msub[1]);
      const float p3 = exp2f(s[n][3] - msub[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16x2(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(p2, p3);
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
    if (lse != nullptr && t == 0 && row0 + 8 * r < Lq)
      lse[((long long)b * gridDim.y + h) * Lq + row0 + 8 * r] = m_run[r] + log2f(l);
  }
  store_rows<D, DP>(o + b * so_b + (long long)h * D, so_l, acc, inv[0], inv[1], row0,
                    Lq, t);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o,
           void* lse, int B, int H, int Lq, int Lk, long long sq_b, long long sq_l,
           long long sk_b, long long sk_l, long long sv_b, long long sv_l,
           long long so_b, long long so_l, float sc_log2, cudaStream_t stream) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LD = DP + 8;
  const size_t smem = (size_t)(BQ + 4 * BK) * LD * sizeof(bf16);
  static const cudaError_t attr_err = allow_smem(flash_fwd_packed_kernel<D>, smem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_packed_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), Lq, Lk, sq_b, sq_l, sk_b,
      sk_l, sv_b, sv_l, so_b, so_l, sc_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Built for the UNet's head dims 40, 80 and 160. Strides are in elements.
// `bias` and `lse` may be null. Returns a cudaError_t value (0 on success).
extern "C" int flash_attn_packed_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, void* o, void* lse, int B,
                                     int H, int Lq, int Lk, int D, long long sq_b,
                                     long long sq_l, long long sk_b, long long sk_l,
                                     long long sv_b, long long sv_l, long long so_b,
                                     long long so_l, float sc_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return launch<40>(q, k, v, bias, o, lse, B, H, Lq, Lk, sq_b, sq_l, sk_b, sk_l,
                        sv_b, sv_l, so_b, so_l, sc_log2, s);
    case 80:
      return launch<80>(q, k, v, bias, o, lse, B, H, Lq, Lk, sq_b, sq_l, sk_b, sk_l,
                        sv_b, sv_l, so_b, so_l, sc_log2, s);
    case 160:
      return launch<160>(q, k, v, bias, o, lse, B, H, Lq, Lk, sq_b, sq_l, sk_b, sk_l,
                         sv_b, sv_l, so_b, so_l, sc_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
