// K10 in fp32: Winograd F(2x2, 3x3) stride-1 SAME 3x3 convolution + bias on
// fp32 NHWC tensors, for Hopper (sm_90a), plain C interface. Replaces the
// TPU kernel adaface_tpu/ops/winograd.py:81 _wino_kernel where it runs in
// fp32 (the bf16 instance is winograd.cu, on wgmma). Function, as
// ops/winograd.py:winograd_conv3x3_plain computes it on fp32 inputs, for
// each 2x2 output tile (b, r, s), whose 4x4 input tile d starts at row
// 2r - 1, column 2s - 1 (SAME padding: zeros outside the image):
//   t_ij = sum_pq BT[i][p] BT[j][q] d[p][q]   (16 positions, each +-d term
//          added in fp32 in the p-then-q order of the TPU kernel)
//   m_ij = t_ij[Cin] . U_ij[Cin, Cout]         (fp32 products and sums)
//   y_ac = sum_ij AT[a][i] AT[c][j] m_ij       (fp32, in ij order), out[2r+a,
//          2s+c] = y_ac + bias
// Every product is an fp32 FFMA with fp32 accumulation: no tensor core, no
// TF32 (the JAX package asks for fp32 products, which TF32 would not give).
//
// Bound: operations. The 16 products are 8*B*H*W*Cin*Cout FFMA flops
// against the fp32 non-tensor peak of 67 TFLOP/s (at B16 64x64 C320:
// 0.8 ms), above x, U and y moved once at the UNet's widths.
//
// Two launches, the simple design first:
//   wino_input_fp32:   a thread takes one channel of one tile: 16 loads,
//                      the 16 t_ij, stores to V [16][M][Cin_p] fp32
//                      (channels past Cin zeros; Cin_p the padded width of
//                      ops/winograd.py:padded_weights, a multiple of 64);
//   wino_product_fp32: a CTA of 256 threads owns 64 tile rows x 64 output
//                      columns and walks the 16 positions, each a "TN"
//                      GEMM of depth Cin_p (V rows and U^T = padded_weights
//                      [16][Cout_p][Cin_p], both K-major), register-blocked
//                      4 x 4 FFMA from ffma_tile.cuh with the stages of 16
//                      channels double-buffered in shared memory by
//                      cp.async across positions. A position's m_ij goes
//                      into the four quadrant accumulators with its A^T
//                      signs; the epilogue adds the bias and writes
//                      depth-to-space into NHWC. No split: each output sums
//                      its products in one thread, in order, so two launches
//                      agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ffma_tile.cuh"

namespace {

using namespace ffma_tile;

constexpr int BM = 64;            // tile rows a CTA
constexpr int BN = 64;            // output columns a CTA
constexpr int MI = BM / 16;       // rows a thread
constexpr int NJ = BN / 16;       // columns a thread
constexpr int TRANSFORM_THREADS = 256;

// B^T and A^T of F(2x2, 3x3) (Lavin & Gray)
__host__ __device__ constexpr int bt(int i, int p) {
  return i == 0 ? (p == 0 ? 1 : p == 2 ? -1 : 0)
       : i == 1 ? (p == 1 || p == 2 ? 1 : 0)
       : i == 2 ? (p == 1 ? -1 : p == 2 ? 1 : 0)
                : (p == 1 ? 1 : p == 3 ? -1 : 0);
}

__device__ __forceinline__ int at(int a, int i) {
  return a == 0 ? (i < 3 ? 1 : 0) : (i == 0 ? 0 : i == 1 ? 1 : -1);
}

__global__ void __launch_bounds__(TRANSFORM_THREADS)
wino_input_fp32(const float* __restrict__ x, float* __restrict__ v, int H, int W, int Cin,
                int Cin_p, long long M) {
  const long long idx = (long long)blockIdx.x * TRANSFORM_THREADS + threadIdx.x;
  if (idx >= M * Cin_p) return;
  const int c = (int)(idx % Cin_p);
  const long long m = idx / Cin_p;
  float t[16];
  if (c < Cin) {
    const int hh = H / 2, wh = W / 2;
    const int s = (int)(m % wh), r = (int)(m / wh % hh);
    const long long b = m / wh / hh;
    float d[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 2 * r - 1 + p, col = 2 * s - 1 + q;
        d[p][q] = (row >= 0 && row < H && col >= 0 && col < W)
                      ? x[((b * H + row) * W + col) * Cin + c]
                      : 0.f;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = 0.f;
        bool first = true;
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int sign = bt(i, p) * bt(j, q);
            if (sign == 0) continue;
            const float term = sign > 0 ? d[p][q] : -d[p][q];
            acc = first ? term : acc + term;
            first = false;
          }
        t[4 * i + j] = acc;
      }
  } else {
#pragma unroll
    for (int ij = 0; ij < 16; ++ij) t[ij] = 0.f;
  }
#pragma unroll
  for (int ij = 0; ij < 16; ++ij) v[((long long)ij * M + m) * Cin_p + c] = t[ij];
}

// y[a * 2 + c] += AT[a][i] AT[c][j] m for position ij = 4 i + j
__device__ __forceinline__ void add_position(float (&y)[4][MI][NJ], const float (&m)[MI][NJ],
                                             int ij) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int coef = at(q / 2, ij / 4) * at(q % 2, ij % 4);
    if (coef == 0) continue;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        y[q][i][j] = coef > 0 ? y[q][i][j] + m[i][j] : y[q][i][j] - m[i][j];
  }
}

__global__ void __launch_bounds__(NT)
wino_product_fp32(const float* __restrict__ v, const float* __restrict__ ut,
                  const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                  int Cout, int Cin_p, int Cout_p, int M) {
  __shared__ __align__(16) float sa[2][BM * LDK];
  __shared__ __align__(16) float sb[2][BN * LDK];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nkc = Cin_p / BK, steps = 16 * nkc;
  // stage st: position st / nkc, channels [st % nkc * BK, + BK)
  auto load = [&](int st, int buf) {
    const int ij = st / nkc, k0 = st % nkc * BK;
    load_tile<BM>(sa[buf], v + (long long)ij * M * Cin_p, Cin_p, m0, M, k0);
    load_tile<BN>(sb[buf], ut + (long long)ij * Cout_p * Cin_p, Cin_p, n0, Cout_p, k0);
  };

  float y[4][MI][NJ], mm[MI][NJ];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) y[q][i][j] = 0.f;
  load(0, 0);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    const int ij = st / nkc, kc = st % nkc;
    if (st + 1 < steps) load(st + 1, (st + 1) & 1);
    cp_async_commit();
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mm[i][j] = 0.f;
    }
    cp_async_wait_one();
    __syncthreads();
    fma_tile<MI, NJ>(mm, sa[st & 1], sb[st & 1], ty, tx);
    __syncthreads();  // the stage is read before the next copies overwrite it
    if (kc == nkc - 1) add_position(y, mm, ij);
  }

  const int hh = H / 2, wh = W / 2;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const int s = m % wh, r = m / wh % hh;
    const long long b = m / wh / hh;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float* o = out + ((b * H + 2 * r + q / 2) * W + 2 * s + q % 2) * Cout;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < Cout) o[n] = y[q][i][j] + bias[n];
      }
    }
  }
}

}  // namespace

// x: [B, H, W, Cin] fp32 NHWC (H, W even); ut: padded_weights(U) fp32 [16,
// Cout_p, Cin_p] (zero-padded, Cin_p and Cout_p multiples of 64); bias:
// [Cout] fp32; v: [16, B*H*W/4, Cin_p] fp32 scratch; out: [B, H, W, Cout]
// fp32. ut and v 16-byte aligned. Returns a cudaError_t (0 on success);
// launches only.
extern "C" int winograd_conv3x3_fp32_fwd(const void* x, const void* ut, const void* bias,
                                         void* v, void* out, int B, int H, int W, int Cin,
                                         int Cout, int Cin_p, int Cout_p, void* stream) {
  if (H % 2 || W % 2 || Cin_p % 64 || Cout_p % BN || Cin > Cin_p || Cout > Cout_p || B <= 0 ||
      H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      ((reinterpret_cast<uintptr_t>(ut) | reinterpret_cast<uintptr_t>(v)) & 15))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * (H / 2) * (W / 2);
  if (M > 0x7fffffffLL || (M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long threads = M * Cin_p;
  wino_input_fp32<<<(unsigned)((threads + TRANSFORM_THREADS - 1) / TRANSFORM_THREADS),
                    TRANSFORM_THREADS, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<float*>(v), H, W, Cin, Cin_p, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wino_product_fp32<<<dim3(Cout_p / BN, (unsigned)((M + BM - 1) / BM)), NT, 0, s>>>(
      static_cast<const float*>(v), static_cast<const float*>(ut),
      static_cast<const float*>(bias), static_cast<float*>(out), H, W, Cout, Cin_p, Cout_p,
      (int)M);
  return (int)cudaGetLastError();
}
