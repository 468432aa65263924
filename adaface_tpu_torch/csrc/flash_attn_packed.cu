// Packed-layout flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   K1  adaface_tpu/ops/flash_attention.py:578  _flash_kernel_heads_pvt
//   K4  adaface_tpu/ops/flash_attention.py:544  _flash_kernel_heads_short
// both reached through _flash_forward_blc / flash_attention_blc.
//
// Function, for each (batch b, head h, query row i):
//   s_j = (q_i . k_j) * scale * log2(e)
//   if a key bias is given: s_j = max(s_j + bias[b, j] * log2(e), -100)
//   o_i = sum_j 2^s_j v_j / sum_j 2^s_j
// q, k, v are [B, L, H*D] views (each with its own batch and row stride, so
// the three thirds of a fused [B, L, 3*H*D] projection work without a copy);
// head h is the column panel [h*D, (h+1)*D). The output is packed [B, Lq, H*D].
// bf16 in and out, fp32 accumulation.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per K/V tile
constexpr int WARPS = 4;     // 16 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCORE_FLOOR = -100.0f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two transposed 8x8 b16 matrices: the B operand of P V from row-major V.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Low half holds `lo` (the smaller column index), as the mma fragments expect.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0 + 64) of one head panel (D columns, row stride
// `stride` elements) into a shared tile with leading dimension LD. Rows past
// `nrows` are written as zeros.
template <int D, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0, int nrows,
                                          int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int i = tid; i < 64 * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool valid = row0 + r < nrows;
    const bf16* g = valid ? src + (long long)(row0 + r) * stride + c : src;
    cp_async_16(dst + r * LD + c, g, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        bf16* __restrict__ o, int Lq, int Lk,
                        long long sq_b, long long sq_l, long long sk_b,
                        long long sk_l, long long sv_b, long long sv_l,
                        long long so_b, long long so_l, float sc_log2) {
  constexpr int DP = (D + 15) / 16 * 16;  // MMA depth granule
  constexpr int LD = DP + 8;              // +16 bytes per row against bank conflicts
  constexpr int NT_D = DP / 8;            // n-tiles of the output panel
  constexpr int KS_D = DP / 16;           // k-steps of Q K^T
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

  // Zero the pad columns [D, DP) of every tile once; cp.async never writes them.
  if constexpr (DP > D) {
    constexpr int PADC = DP - D;
    for (int i = tid; i < (BQ + 4 * BK) * PADC; i += THREADS)
      Qs[(i / PADC) * LD + D + i % PADC] = __float2bfloat16(0.0f);
  }

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
#pragma unroll
    for (int kk = 0; kk < KS_D; ++kk) {
      const bf16* qa = Qs + (wrow + g) * LD + kk * 16 + t * 2;
      uint32_t a[4];
      a[0] = ld_u32(qa);
      a[1] = ld_u32(qa + 8 * LD);
      a[2] = ld_u32(qa + 8);
      a[3] = ld_u32(qa + 8 * LD + 8);
#pragma unroll
      for (int n = 0; n < NT_K; ++n) {
        const bf16* kb = Kt + (n * 8 + g) * LD + kk * 16 + t * 2;
        mma_16816(s[n], a, ld_u32(kb), ld_u32(kb + 8));
      }
    }

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
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
      for (int nd = 0; nd < NT_D; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, Vt + (j * 16 + (lane & 15)) * LD + nd * 8);
        mma_16816(acc[nd], pa[j], b0, b1);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / l;
  }
  bf16* op = o + b * so_b + (long long)h * D;
  const int row0 = q0 + wrow + g;
#pragma unroll
  for (int nd = 0; nd < NT_D; ++nd) {
    const int col = nd * 8 + t * 2;
    if (col < D) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < Lq)
          *reinterpret_cast<uint32_t*>(op + row * so_l + col) =
              pack_bf16x2(acc[nd][2 * r] * inv[r], acc[nd][2 * r + 1] * inv[r]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o,
           int B, int H, int Lq, int Lk, long long sq_b, long long sq_l,
           long long sk_b, long long sk_l, long long sv_b, long long sv_l,
           long long so_b, long long so_l, float sc_log2, cudaStream_t stream) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LD = DP + 8;
  const size_t smem = (size_t)(BQ + 4 * BK) * LD * sizeof(bf16);
  // Opt in to more than 48 KB of dynamic shared memory once per head dim
  // (thread-safe static initialisation), not on every launch.
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      flash_fwd_packed_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_packed_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(o), Lq, Lk, sq_b, sq_l, sk_b, sk_l, sv_b, sv_l, so_b,
      so_l, sc_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Built for the UNet's head dims 40, 80 and 160. Strides are in elements.
// Returns a cudaError_t value (0 on success).
extern "C" int flash_attn_packed_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, void* o, int B, int H,
                                     int Lq, int Lk, int D, long long sq_b,
                                     long long sq_l, long long sk_b, long long sk_l,
                                     long long sv_b, long long sv_l, long long so_b,
                                     long long so_l, float sc_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return launch<40>(q, k, v, bias, o, B, H, Lq, Lk, sq_b, sq_l, sk_b, sk_l,
                        sv_b, sv_l, so_b, so_l, sc_log2, s);
    case 80:
      return launch<80>(q, k, v, bias, o, B, H, Lq, Lk, sq_b, sq_l, sk_b, sk_l,
                        sv_b, sv_l, so_b, so_l, sc_log2, s);
    case 160:
      return launch<160>(q, k, v, bias, o, B, H, Lq, Lk, sq_b, sq_l, sk_b, sk_l,
                         sv_b, sv_l, so_b, so_l, sc_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
