// Winograd F(2x2, 3x3) stride-1 SAME 3x3 convolution + bias for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel of the JAX package
//   K10 adaface_tpu/ops/winograd.py:81  _wino_kernel
// reached through winograd_conv3x3 / conv3x3_same under ADAFACE_WINOGRAD.
//
// Function, NHWC x [B, H, W, Cin] bf16 (H, W even), transformed weights
// U [16, Cin, Cout] bf16 (U_ij = (G g G^T)_ij, made by the caller), bias
// [Cout] bf16. For each 2x2 output tile (b, r, s), whose 4x4 input tile d
// starts at row 2r - 1, column 2s - 1 (SAME padding, rows and columns
// outside the image read as zeros):
//   t_ij = sum_pq BT[i][p] BT[j][q] d[p][q]   (16 positions; each +-d term
//          added in bf16 and rounded after every add, p outer, q inner, as
//          XLA rounds the TPU kernel's bf16 adds)
//   m_ij = t_ij[Cin] . U_ij[Cin, Cout]         (fp32 accumulation)
//   y_ac = sum_ij AT[a][i] AT[c][j] m_ij       (fp32), out[2r+a, 2s+c] =
//          bf16(y_ac + bias)
//
// What bounds it on an H100: the 16 products are 2*16*(B*H*W/4)*Cin*Cout =
// 8*B*H*W*Cin*Cout tensor-core flops, against 18*B*H*W*Cin*Cout for the
// direct conv; at the UNet's widths (Cin, Cout 320..2560) that is above the
// bytes of x, U and y moved once, so the products bound it. Two launches,
// a simple design first:
//   (a) input transform: one thread per (tile, input channel), 16 input
//       reads (neighbouring threads on neighbouring channels), 16 t_ij
//       written to V [16][tiles][Cin_p] bf16 (channels zero-padded to
//       Cin_p, the caller's multiple of 32). V is 4x the input's bytes, the
//       price of not fusing (a) into (b).
//   (b) the 16 products: grid (ceil(tiles / 64), Cout_p / 64); 4 warps of
//       16 tile rows; V and U tiles [64, 32] and [32, 64] double-buffered in
//       shared memory by cp.async over the flat (position, K chunk)
//       sequence; mma.sync m16n8k16 bf16, the position's m_ij in registers,
//       added with its A^T signs into the four fp32 output quadrants, which
//       stay in registers through all 16 positions; the epilogue adds the
//       bias and writes depth-to-space straight into NHWC.
// Later work (wgmma, the transform fused into the product's loads, one
// launch) is for a PR that makes it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::cp_async_16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::ldmatrix_x2_trans;
using flash::load_a;
using flash::mma_16816;

constexpr int MT = 64;          // tile rows per block
constexpr int NT = 64;          // output channels per block
constexpr int KT = 32;          // depth per stage
constexpr int LDA = KT + 8;     // +16 bytes per row against bank conflicts
constexpr int LDB = NT + 8;
constexpr int THREADS = 128;
constexpr int TRANSFORM_THREADS = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

__global__ void __launch_bounds__(TRANSFORM_THREADS)
wino_input_kernel(const bf16* __restrict__ x, bf16* __restrict__ v, int H, int W,
                  int Cin, int Cin_p, long long M) {
  const long long idx = (long long)blockIdx.x * TRANSFORM_THREADS + threadIdx.x;
  if (idx >= M * Cin_p) return;
  const int c = (int)(idx % Cin_p);
  const long long m = idx / Cin_p;
  const int hh = H / 2, wh = W / 2;
  const int s = (int)(m % wh);
  const int r = (int)((m / wh) % hh);
  const long long b = m / ((long long)wh * hh);

  float d[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 2 * r + p - 1, col = 2 * s + q - 1;
      const bool in = c < Cin && row >= 0 && row < H && col >= 0 && col < W;
      d[p][q] = in ? __bfloat162float(x[((b * H + row) * W + col) * Cin + c]) : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float t = 0.0f;
      bool first = true;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (bt(i, p) == 0 || bt(j, q) == 0) continue;
          const float term = bt(i, p) * bt(j, q) > 0 ? d[p][q] : -d[p][q];
          t = first ? term : round_bf16(t + term);
          first = false;
        }
      }
      v[((long long)(4 * i + j) * M + m) * Cin_p + c] = __float2bfloat16_rn(t);
    }
  }
}

// Stage (position ij, K chunk kc): V rows [m0, m0 + 64) x channels [kc*32,
// +32) and U rows [kc*32, +32) x columns [n0, n0 + 64). Rows past M are zeros.
__device__ __forceinline__ void load_stage(bf16* As, bf16* Bs, const bf16* v,
                                           const bf16* u, int ij, int kc, long long M,
                                           long long m0, int n0, int Cin_p, int Cout_p,
                                           int tid) {
  const bf16* vp = v + (long long)ij * M * Cin_p + (long long)kc * KT;
#pragma unroll
  for (int i = tid; i < MT * (KT / 8); i += THREADS) {
    const int r = i / (KT / 8), c8 = (i % (KT / 8)) * 8;
    const bool valid = m0 + r < M;
    const bf16* src = valid ? vp + (m0 + r) * Cin_p + c8 : vp;
    cp_async_16(As + r * LDA + c8, src, valid);
  }
  const bf16* up = u + ((long long)ij * Cin_p + (long long)kc * KT) * Cout_p + n0;
#pragma unroll
  for (int i = tid; i < KT * (NT / 8); i += THREADS) {
    const int r = i / (NT / 8), c8 = (i % (NT / 8)) * 8;
    cp_async_16(Bs + r * LDB + c8, up + (long long)r * Cout_p + c8, true);
  }
}

__global__ void __launch_bounds__(THREADS)
wino_product_kernel(const bf16* __restrict__ v, const bf16* __restrict__ u,
                    const bf16* __restrict__ bias, bf16* __restrict__ out, int H, int W,
                    int Cout, int Cin_p, int Cout_p, long long M) {
  __shared__ __align__(16) unsigned char smem_raw[(2 * MT * LDA + 2 * KT * LDB) * 2];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [2][MT][LDA] V tiles
  bf16* Bs = As + 2 * MT * LDA;                   // [2][KT][LDB] U tiles

  const long long m0 = (long long)blockIdx.x * MT;
  const int n0 = blockIdx.y * NT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16;
  const int nk = Cin_p / KT;
  const int steps = 16 * nk;

  float y[2][2][NT / 8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int n = 0; n < NT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[a][c][n][e] = 0.0f;
  float mac[NT / 8][4];

  load_stage(As, Bs, v, u, 0, 0, M, m0, n0, Cin_p, Cout_p, tid);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    const int ij = st / nk, kc = st % nk;
    if (st + 1 < steps) {
      load_stage(As + (buf ^ 1) * MT * LDA, Bs + (buf ^ 1) * KT * LDB, v, u, (st + 1) / nk,
                 (st + 1) % nk, M, m0, n0, Cin_p, Cout_p, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kc == 0) {
#pragma unroll
      for (int n = 0; n < NT / 8; ++n) mac[n][0] = mac[n][1] = mac[n][2] = mac[n][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t afr[4];
      load_a<LDA>(afr, As + buf * MT * LDA, wrow, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT / 8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, Bs + buf * KT * LDB + (kk * 16 + (lane & 15)) * LDB + n * 8);
        mma_16816(mac[n], afr, b0, b1);
      }
    }
    if (kc == nk - 1) {  // m_ij is complete: y_ac += AT[a][i] AT[c][j] m_ij
      const int i = ij >> 2, j = ij & 3;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float coef = (float)(at(a, i) * at(c, j));
          if (coef != 0.0f) {
#pragma unroll
            for (int n = 0; n < NT / 8; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) y[a][c][n][e] += coef * mac[n][e];
          }
        }
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  // epilogue: + bias in fp32, one cast, depth-to-space into NHWC
  const int hh = H / 2, wh = W / 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long m = m0 + wrow + g + 8 * half;
    if (m >= M) continue;
    const int s = (int)(m % wh);
    const int r = (int)((m / wh) % hh);
    const long long b = m / ((long long)wh * hh);
#pragma unroll
    for (int n = 0; n < NT / 8; ++n) {
      const int col = n0 + n * 8 + 2 * t;
      if (col >= Cout) continue;
      const bool two = col + 1 < Cout;
      const float b0 = __bfloat162float(bias[col]);
      const float b1 = two ? __bfloat162float(bias[col + 1]) : 0.0f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          bf16* dst = out + ((b * H + 2 * r + a) * W + 2 * s + c) * Cout + col;
          const float v0 = y[a][c][n][2 * half] + b0;
          const float v1 = y[a][c][n][2 * half + 1] + b1;
          if (two && (Cout & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          } else {
            dst[0] = __float2bfloat16_rn(v0);
            if (two) dst[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

}  // namespace

// x [B, H, W, Cin] bf16 contiguous, H and W even; up [16, Cin_p, Cout_p]
// bf16, the transformed weights zero-padded (Cin_p a multiple of 32, Cout_p
// of 64); bias [Cout] bf16; v scratch [16, B*H*W/4, Cin_p] bf16; out
// [B, H, W, Cout] bf16. Returns a cudaError_t value (0 on success).
extern "C" int winograd_conv3x3_fwd(const void* x, const void* up, const void* bias,
                                    void* v, void* out, int B, int H, int W, int Cin,
                                    int Cout, int Cin_p, int Cout_p, void* stream) {
  if (H % 2 || W % 2 || Cin_p % KT || Cout_p % NT || Cin > Cin_p || Cout > Cout_p ||
      B <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * (H / 2) * (W / 2);
  const long long n = M * Cin_p;
  wino_input_kernel<<<(unsigned)((n + TRANSFORM_THREADS - 1) / TRANSFORM_THREADS),
                      TRANSFORM_THREADS, 0, s>>>(static_cast<const bf16*>(x),
                                                 static_cast<bf16*>(v), H, W, Cin, Cin_p, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + MT - 1) / MT), Cout_p / NT);
  wino_product_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const bf16*>(v), static_cast<const bf16*>(up),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), H, W, Cout, Cin_p, Cout_p,
      M);
  return (int)cudaGetLastError();
}
