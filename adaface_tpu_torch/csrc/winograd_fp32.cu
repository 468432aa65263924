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
//   y_ac = sum_ij AT[a][i] AT[c][j] m_ij       (fp32), out[2r+a, 2s+c] =
//          y_ac + bias
// Every product is an fp32 FFMA with fp32 accumulation: no tensor core, no
// TF32 (the JAX package asks for fp32 products, which TF32 would not give).
// U comes as ops/winograd.py:padded_weights_fp32 lays it out: U^T [16][Cout]
// [Cin_p], K-major, Cin_p = Cin rounded up to 16 with zeros.
//
// Bound: operations where both widths are large (8*B*H*W*Cin*Cout FFMA
// flops against the fp32 non-tensor peak of 67 TFLOP/s: 0.8 ms at B16 64x64
// C320), bytes where one is 4 (the UNet's in- and out-conv: x and y moved
// once, 0.013 and 0.025 ms). So there are three paths, chosen by the plan
// (ops/winograd.py fp32_launch_plan), which the C entry checks:
//
// General (the other widths): wino_input_fp32 writes V [16][M][Cin_p] (a
// thread four channels of a tile, or one where Cin is no multiple of 4),
// then wino32_product runs the 16 position GEMMs on K9's fp32 design
// (ln_geglu_ff_fp32.cu): a CTA of 256 threads takes 128 tile rows by 64
// output columns, each thread 8 rows by 4 columns, an outer product a k
// from shared-memory stages of BKS = 16 channels held transposed
// ([k][row]), fed by a per-thread ring of RING cp.async slots that each
// thread transposes itself (no barrier on the ring, one a stage). Step st
// is position st / nkc, channels st % nkc * BKS.. (nkc = Cin_p / BKS); a
// position's product is folded into the four quadrant accumulators y with
// its A^T signs when its last step (or the slice's) is done. The quadrants
// are what limits the tile: with the running product they take 5 * 32
// registers (231 in all on an H100, one CTA an SM). Kept in shared-memory
// slots that each thread owns they measured 1-4% slower; 8 x 8 a thread
// (128 x 128, stages of 8 channels) with three of them in such slots was no
// faster where Cout is a multiple of 128 and slower at Cout 320 (PERF.md,
// PR 18). The plan
// splits the 16 * nkc steps where the tiles leave SMs idle: each slice
// writes its quadrants to ws [split][4][M][Cout] and wino32_split_sum adds
// them in slice order, + bias.
//
// Narrow in (Cin 4, the UNet's in-conv): no V. wino32_narrow_in takes 64
// tiles a CTA: its threads compute the tiles' t_ij (a float4 of the four
// channels) into shared memory, then each lane of a warp owns one output
// column, holds its 16 * 4 weights in registers and walks the tiles: t from
// shared memory (broadcast), 64 FFMA, the output transform, four stores that
// the warp's lanes make 128 contiguous bytes.
//
// Narrow out (Cout 4, Cin a multiple of 4, the UNet's out-conv): no V.
// wino32_narrow_out gives each tile a team of TEAM = 8 lanes that split its
// channel groups of 4 (group g to lane g % TEAM), so one load instruction
// reads 128 contiguous bytes of each of 4 pixels: x as float4 of the 16
// pixels, t_ij, then each product t_ij .
// U_ij[co] (U as float4 of 4 channels) goes straight into the row sums z_ic
// = sum_j AT[c][j] m_ij of the output transform; each lane finishes the
// transform on its partial sums and the team adds its lanes' quadrants by
// xor shuffles, whose sums are commutative, so every lane holds the same
// total.
//
// Every sum runs in a fixed order (no atomics): two launches agree bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ffma_tile.cuh"  // cp_async16, cp_async_commit

namespace {

using ffma_tile::cp_async16;
using ffma_tile::cp_async_commit;

constexpr int NT = 256;            // threads a general or narrow CTA
constexpr int BK = 16;             // Cin_p's multiple (channels)
constexpr int RING = 2;            // copy ring slots of the general tile
constexpr int MAX_SPLIT = 16;      // slices of the general path's steps
constexpr int IN_TILES = 64;       // tiles a narrow in CTA (Cin 4)
constexpr int OUT_THREADS = 128;   // threads a narrow out CTA
constexpr int TEAM = 8;            // lanes a narrow out tile
constexpr int PATH_GENERAL = 0, PATH_NARROW_IN = 1, PATH_NARROW_OUT = 2;

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 operator-(float4 a) { return make_float4(-a.x, -a.y, -a.z, -a.w); }

// B^T and A^T of F(2x2, 3x3) (Lavin & Gray)
__host__ __device__ constexpr int bt(int i, int p) {
  return i == 0 ? (p == 0 ? 1 : p == 2 ? -1 : 0)
       : i == 1 ? (p == 1 || p == 2 ? 1 : 0)
       : i == 2 ? (p == 1 ? -1 : p == 2 ? 1 : 0)
                : (p == 1 ? 1 : p == 3 ? -1 : 0);
}

__host__ __device__ constexpr int at(int a, int i) {
  return a == 0 ? (i < 3 ? 1 : 0) : (i == 0 ? 0 : i == 1 ? 1 : -1);
}

// t_ij of one tile (T = float: a channel; float4: four): the +-d terms in
// p-then-q order
template <class T>
__device__ __forceinline__ T input_position(const T (&d)[4][4], int i, int j) {
  T acc = d[0][0];
  bool first = true;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int sign = bt(i, p) * bt(j, q);
      if (sign == 0) continue;
      const T term = sign > 0 ? d[p][q] : -d[p][q];
      acc = first ? term : acc + term;
      first = false;
    }
  return acc;
}

// Tile m's image b, tile row r and column s; its first output pixel (NHWC
// pixel index of out[b, 2r, 2s]).
struct TilePos {
  int b, r, s;
  __device__ __forceinline__ TilePos(int m, int H, int W)
      : b(m / (W / 2) / (H / 2)), r(m / (W / 2) % (H / 2)), s(m % (W / 2)) {}
  __device__ __forceinline__ long long pixel(int H, int W) const {
    return ((long long)b * H + 2 * r) * W + 2 * s;
  }
};

// The 4x4 input tile of tile (b, r, s) at channel offset c (T as above;
// zeros outside the image, and everywhere where !live).
template <class T>
__device__ __forceinline__ void load_window(T (&d)[4][4], const float* __restrict__ x,
                                            const TilePos& t, bool live, int H, int W, int C,
                                            int c) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 2 * t.r - 1 + p, col = 2 * t.s - 1 + q;
      const float* src = x + (((long long)t.b * H + row) * W + col) * C + c;
      if (!(live && row >= 0 && row < H && col >= 0 && col < W))
        d[p][q] = T{};
      else if constexpr (sizeof(T) == sizeof(float4))
        d[p][q] = *reinterpret_cast<const float4*>(src);
      else
        d[p][q] = *src;
    }
}

// No memory access moves across it (the compiler's scheduling alone).
__device__ __forceinline__ void compiler_fence() { asm volatile("" ::: "memory"); }

// y[q] += AT[q / 2][i] AT[q % 2][j] m for the quadrants q that position
// ij = 4 i + j reaches (the narrow in path's output transform, a position
// at a time)
__device__ __forceinline__ void add_position(float (&y)[4], float m, int ij) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int coef = at(q / 2, ij / 4) * at(q % 2, ij % 4);
    if (coef == 0) continue;  // position ij adds nothing to quadrant q
    y[q] = coef > 0 ? y[q] + m : y[q] - m;
  }
}

// ----------------------------------------------------------- general path

// V [16][M][Cin_p] from x: a thread VW channels (4, or 1 where Cin is no
// multiple of 4) of a tile; zeros past Cin.
template <int VW>
__global__ void __launch_bounds__(NT)
wino_input_fp32(const float* __restrict__ x, float* __restrict__ v, int H, int W, int Cin,
                int Cin_p, int M) {
  using T = typename std::conditional<VW == 4, float4, float>::type;
  const int idx = blockIdx.x * NT + threadIdx.x, groups = Cin_p / VW;
  if (idx >= M * groups) return;  // the C entry keeps M * groups under 2^31
  const int c = idx % groups * VW, m = idx / groups;
  T d[4][4];
  load_window(d, x, TilePos(m, H, W), c < Cin, H, W, Cin, c);
#pragma unroll
  for (int ij = 0; ij < 16; ++ij)
    *reinterpret_cast<T*>(v + ((long long)ij * M + m) * Cin_p + c) =
        input_position(d, ij / 4, ij % 4);
}

// The general tile: 256 threads of MI rows by NJ columns (runs of 4, 64
// apart) make BM tile rows by BN output columns; stages of BKS channels.
constexpr int MI = 8, NJ = 4, BKS = 16;
constexpr int BM = 16 * MI, BN = 16 * NJ;
constexpr int LDA = BM + 4;                 // floats between the k rows of an A stage
constexpr int LDB = BN + 4;                 // and of a B stage
constexpr int A4 = BM * BKS / 4 / NT;       // float4 of V a thread copies a stage
constexpr int B4 = BN * BKS / 4 / NT;       // of U^T
constexpr int RAW = (A4 + B4) * NT * 4;     // floats a slot of the copy ring
// the copy ring, the two transposed stages
constexpr size_t PRODUCT_SMEM = (RING * RAW + 2 * BKS * (LDA + LDB)) * sizeof(float);
static_assert(A4 >= 1 && B4 >= 1 && BM * BKS / 4 % NT == 0 && BN * BKS / 4 % NT == 0 &&
              BK % BKS == 0, "whole float4 a thread, stages within Cin_p");

struct GArgs {
  const float* v;     // [16][M][Cin_p]
  const float* ut;    // [16][Cout][Cin_p]
  const float* bias;  // [Cout]
  float* out;         // out [B, H, W, Cout], or ws [split][4][M][Cout] where split > 1
  int H, W, Cout, Cin_p, M;
  int ncol, split;    // column blocks, slices of the steps
};

// All but this thread's newest RING - 2 groups of copies have landed.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
}

// One CTA an SM (shared memory).
__global__ void __launch_bounds__(NT, 1) wino32_product(GArgs p) {
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);  // [RING][RAW]
  float* sa = raw + RING * RAW;                  // [2][BKS][LDA]
  float* sb = sa + 2 * BKS * LDA;                // [2][BKS][LDB]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tm = warp / 2 * 4 + lane / 8;  // rows 4 tm .. + 3 (+ 64 h)
  const int tn = warp % 2 * 8 + lane % 8;  // columns 4 tn .. + 3 (+ 64 g)
  // tile blockIdx.x: slice s fastest, then column block, then row block
  const int s = blockIdx.x % p.split, nb = blockIdx.x / p.split % p.ncol;
  const int m0 = blockIdx.x / p.split / p.ncol * BM, n0 = nb * BN;
  const int nkc = p.Cin_p / BKS, steps = 16 * nkc;
  const int k0 = s * steps / p.split, k1 = (s + 1) * steps / p.split;

  // Copy i of a stage (idx = tid + i NT) is 4 channels, 4 (idx % (BKS /
  // 4)) .., of row idx / (BKS / 4): of V for i < A4, then of U^T; rows past
  // M or Cout read as zeros. A thread reads back only its own copies, so
  // the ring needs no barrier.
  auto issue = [&](int st, int slot) {
    float* r = raw + slot * RAW;
    const int ij = st / nkc, c0 = st % nkc * BKS;
    const float* va = p.v + (long long)ij * p.M * p.Cin_p + c0;
    const float* ub = p.ut + (long long)ij * p.Cout * p.Cin_p + c0;
#pragma unroll
    for (int i = 0; i < A4; ++i) {
      const int idx = tid + i * NT, row = m0 + idx / (BKS / 4);
      const bool valid = row < p.M;
      cp_async16(r + 4 * idx,
                 va + (long long)(valid ? row : 0) * p.Cin_p + 4 * (idx % (BKS / 4)), valid);
    }
#pragma unroll
    for (int i = 0; i < B4; ++i) {
      const int idx = tid + i * NT, col = n0 + idx / (BKS / 4);
      const bool valid = col < p.Cout;
      cp_async16(r + 4 * (A4 * NT + idx),
                 ub + (long long)(valid ? col : 0) * p.Cin_p + 4 * (idx % (BKS / 4)), valid);
    }
  };
  // this thread's landed copies in ring slot `slot` into stage buffer
  // `buf`, transposed: [k][row]
  auto transpose = [&](int slot, int buf) {
    const float* r = raw + slot * RAW;
    float* da = sa + buf * BKS * LDA;
    float* db = sb + buf * BKS * LDB;
#pragma unroll
    for (int i = 0; i < A4 + B4; ++i) {
      const int idx = tid + (i < A4 ? i : i - A4) * NT;
      const int row = idx / (BKS / 4), k = 4 * (idx % (BKS / 4));
      const float4 v = *reinterpret_cast<const float4*>(r + 4 * (tid + i * NT));
      float* d = i < A4 ? da + row : db + row;
      const int ld = i < A4 ? LDA : LDB;
      d[k * ld] = v.x;
      d[(k + 1) * ld] = v.y;
      d[(k + 2) * ld] = v.z;
      d[(k + 3) * ld] = v.w;
    }
  };

  // y[q][i][j]: quadrant q of row i, column j; mm: the running product
  float y[4][MI][NJ], mm[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mm[i][j] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) y[q][i][j] = 0.f;
    }
  // mm folded into the quadrants with position ij's A^T signs, then cleared
  auto fold = [&](int ij) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int coef = at(q / 2, ij / 4) * at(q % 2, ij % 4);
      if (coef == 0) continue;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          y[q][i][j] = coef > 0 ? y[q][i][j] + mm[i][j] : y[q][i][j] - mm[i][j];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mm[i][j] = 0.f;
  };

  // the ring: step st of the slice in slot (st - k0) % RING, copies of
  // RING - 1 steps in flight; its transposed buffer is (st - k0) % 2
#pragma unroll
  for (int i = 0; i + 1 < RING; ++i) {
    if (k0 + i < k1) issue(k0 + i, i);
    cp_async_commit();
  }
  cp_async_wait_ring();
  transpose(0, 0);
  __syncthreads();
  for (int st = k0; st < k1; ++st) {
    const int i0 = st - k0, cur = i0 & 1;
    const float* da = sa + cur * BKS * LDA;
    const float* db = sb + cur * BKS * LDB;
    if (st + RING - 1 < k1) issue(st + RING - 1, (i0 + RING - 1) % RING);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BKS; ++kk) {
      float fa[MI], fb[NJ];
#pragma unroll
      for (int h = 0; h < MI / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(da + kk * LDA + 64 * h + 4 * tm);
        fa[4 * h] = v.x, fa[4 * h + 1] = v.y, fa[4 * h + 2] = v.z, fa[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < NJ / 4; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(db + kk * LDB + 64 * g + 4 * tn);
        fb[4 * g] = w.x, fb[4 * g + 1] = w.y, fb[4 * g + 2] = w.z, fb[4 * g + 3] = w.w;
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mm[i][j] = fmaf(fa[i], fb[j], mm[i][j]);
    }
    if (st % nkc == nkc - 1 || st + 1 == k1) fold(st / nkc);
    if (st + 1 < k1) {
      // step st + 1's copies have landed; the other buffer was last read
      // before the previous step's barrier
      cp_async_wait_ring();
      transpose((i0 + 1) % RING, cur ^ 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int m = m0 + 4 * tm + 64 * (i / 4) + i % 4;
    if (m >= p.M) continue;
    const TilePos t(m, p.H, p.W);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float* o = p.split > 1 ? p.out + ((long long)(s * 4 + q) * p.M + m) * p.Cout
                             : p.out + (t.pixel(p.H, p.W) + (q / 2) * p.W + q % 2) * p.Cout;
#pragma unroll
      for (int g = 0; g < NJ / 4; ++g) {
        const int col = n0 + 64 * g + 4 * tn;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = y[q][i][4 * g + j];
          if (p.split == 1 && col + j < p.Cout) v[j] = v[j] + p.bias[col + j];
        }
        if (p.Cout % 4 == 0) {
          if (col < p.Cout)
            *reinterpret_cast<float4*>(o + col) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < p.Cout) o[col + j] = v[j];
        }
      }
    }
  }
}

// out[pixel of (m, q)][n] = ((ws[0][q][m][n] + ws[1][q][m][n]) + ...) +
// bias[n], the slices in order; a thread VW columns (4 where Cout is a
// multiple of 4, else 1).
template <int VW>
__global__ void __launch_bounds__(NT)
wino32_split_sum(const float* __restrict__ ws, const float* __restrict__ bias,
                 float* __restrict__ out, int H, int W, int Cout, int M, int split) {
  const int idx = blockIdx.x * NT + threadIdx.x, groups = Cout / VW;
  if (idx >= 4 * M * groups) return;  // the C entry keeps 4 M groups under 2^31
  const int mq = idx / groups, n = idx % groups * VW, m = mq % M, q = mq / M;
  const long long total = 4LL * M * Cout, e = (long long)mq * Cout + n;
  float* o = out + (TilePos(m, H, W).pixel(H, W) + (q / 2) * W + q % 2) * Cout + n;
  float v[VW];
#pragma unroll
  for (int e4 = 0; e4 < VW; ++e4) v[e4] = ws[e + e4];
  for (int s = 1; s < split; ++s)
#pragma unroll
    for (int e4 = 0; e4 < VW; ++e4) v[e4] = v[e4] + ws[s * total + e + e4];
#pragma unroll
  for (int e4 = 0; e4 < VW; ++e4) o[e4] = v[e4] + bias[n + e4];
}

// ------------------------------------------------------------ narrow paths

// Cin 4: CTA (blockIdx.x, blockIdx.y) takes tiles 64 x .. + 63 and output
// columns 32 (blockIdx.y * warps + warp) + lane.
__global__ void __launch_bounds__(NT)
wino32_narrow_in(const float* __restrict__ x, const float* __restrict__ ut,
                 const float* __restrict__ bias, float* __restrict__ out, int H, int W, int Cout,
                 int Cin_p, int M) {
  extern __shared__ float4 smem4[];
  float4* ts = smem4;  // [IN_TILES][16]: t_ij of the CTA's tiles
  long long* base = reinterpret_cast<long long*>(ts + IN_TILES * 16);  // [IN_TILES]: pixels
  const int m0 = blockIdx.x * IN_TILES;
  for (int tile = threadIdx.x; tile < IN_TILES; tile += blockDim.x) {
    const TilePos t(m0 + tile, H, W);
    float4 d[4][4];
    load_window(d, x, t, m0 + tile < M, H, W, 4, 0);
#pragma unroll
    for (int ij = 0; ij < 16; ++ij) ts[tile * 16 + ij] = input_position(d, ij / 4, ij % 4);
    base[tile] = t.pixel(H, W);
  }
  const int warps = blockDim.x / 32;
  const int n = (blockIdx.y * warps + threadIdx.x / 32) * 32 + threadIdx.x % 32;
  const bool live = n < Cout;
  float4 u[16];  // U_ij[.., n] of this lane's column
#pragma unroll
  for (int ij = 0; ij < 16; ++ij)
    u[ij] = live ? *reinterpret_cast<const float4*>(ut + ((long long)ij * Cout + n) * Cin_p)
                 : float4{};
  const float bn = live ? bias[n] : 0.f;
  __syncthreads();
  if (!live) return;
  const int tiles = M - m0 < IN_TILES ? M - m0 : IN_TILES;
  for (int tile = 0; tile < tiles; ++tile) {
    float mv[16];
#pragma unroll
    for (int ij = 0; ij < 16; ++ij) {
      const float4 t = ts[tile * 16 + ij];
      mv[ij] = fmaf(t.w, u[ij].w, fmaf(t.z, u[ij].z, fmaf(t.y, u[ij].y, t.x * u[ij].x)));
    }
    float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ij = 0; ij < 16; ++ij) add_position(y, mv[ij], ij);
    float* o = out + base[tile] * Cout + n;
#pragma unroll
    for (int q = 0; q < 4; ++q) o[((q / 2) * W + q % 2) * Cout] = y[q] + bn;
  }
}

// Cout 4: thread i of the launch is lane i % team of tile i / team's team;
// the team sums channel groups g = i % team, + team, .. of Cin / 4. The C
// entry passes team = TEAM: with the width a constant, nvcc schedules the
// channel loop in 148 registers instead of 192, and the kernel takes 1.4-1.5x
// as long (PERF.md, PR 18).
__global__ void __launch_bounds__(OUT_THREADS)
wino32_narrow_out(const float* __restrict__ x, const float* __restrict__ ut,
                  const float* __restrict__ bias, float* __restrict__ out, int H, int W, int Cin,
                  int Cin_p, int M, int team) {
  const int lane = threadIdx.x % 32, cs = lane % team;
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) / team;
  const bool live = m < M;
  const TilePos t(live ? m : 0, H, W);
  // z[i][c][co] = sum over j of AT[c][j] m_ij[co], over this lane's
  // channel groups: 32 accumulators (the 64 m_ij spilled at 255 registers)
  float z[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int co = 0; co < 4; ++co) z[i][0][co] = z[i][1][co] = 0.f;
  for (int g = cs; g < Cin / 4; g += team) {
    float4 d[4][4];
    load_window(d, x, t, live, H, W, Cin, 4 * g);
#pragma unroll
    for (int ij = 0; ij < 16; ++ij) {
      // U's loads held to two positions ahead: all 64 float4 at once
      // spilled at 255 registers
      if (ij % 2 == 0) compiler_fence();
      const int i = ij / 4, j = ij % 4;
      const float4 tv = input_position(d, i, j);
#pragma unroll
      for (int co = 0; co < 4; ++co) {
        const float4 w = *reinterpret_cast<const float4*>(
            ut + ((long long)ij * 4 + co) * Cin_p + 4 * g);
        if (j == 0 || j == 3) {  // one row sum: AT[0][0] = 1, AT[1][3] = -1
          const float sg = j == 0 ? 1.f : -1.f;
          float& a = z[i][j == 3][co];
          a = fmaf(sg * tv.w, w.w, fmaf(sg * tv.z, w.z, fmaf(sg * tv.y, w.y, fmaf(sg * tv.x, w.x, a))));
        } else {  // both: AT[0][j] = 1, AT[1][j] = 1 (j 1) or -1 (j 2)
          const float mv = fmaf(tv.w, w.w, fmaf(tv.z, w.z, fmaf(tv.y, w.y, tv.x * w.x)));
          z[i][0][co] = z[i][0][co] + mv;
          z[i][1][co] = j == 1 ? z[i][1][co] + mv : z[i][1][co] - mv;
        }
      }
    }
  }
  // y[co][2 a + c] = sum over i of AT[a][i] z[i][c][co], i in order: this
  // lane's part of the output transform
  float y[4][4];
#pragma unroll
  for (int co = 0; co < 4; ++co)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int coef = at(q / 2, i);
        if (coef != 0) acc = coef > 0 ? acc + z[i][q % 2][co] : acc - z[i][q % 2][co];
      }
      y[co][q] = acc;
    }
  for (int o = 1; o < team; o <<= 1)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int co = 0; co < 4; ++co) y[co][q] += __shfl_xor_sync(0xffffffffu, y[co][q], o);
  if (!live) return;
  const long long px = t.pixel(H, W);
#pragma unroll
  for (int q = 0; q < 4; ++q)  // lane cs of the team writes quadrants cs, cs + team, ..
    if (q % team == cs)
      *reinterpret_cast<float4*>(out + (px + (q / 2) * W + q % 2) * 4) =
          make_float4(y[0][q] + bias[0], y[1][q] + bias[1], y[2][q] + bias[2], y[3][q] + bias[3]);
}

cudaError_t launch_product(const GArgs& p, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      wino32_product, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PRODUCT_SMEM);
  if (err != cudaSuccess) return err;
  const long long rows = ((long long)p.M + BM - 1) / BM;
  wino32_product<<<(unsigned)(rows * p.ncol * p.split), NT, PRODUCT_SMEM, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x: [B, H, W, Cin] fp32 NHWC (H, W even); ut: ops/winograd.py
// padded_weights_fp32(U), [16, Cout, Cin_p] fp32 (Cin_p = Cin rounded up to
// 16, zeros past Cin); bias: [Cout] fp32; out: [B, H, W, Cout] fp32. The
// plan (ops/winograd.py fp32_launch_plan): path 0 general (split 1..16
// slices of the 16 Cin_p / 16 steps, at most that many; v [16, B H W / 4,
// Cin_p] and, where split > 1, ws [split, 4, B H W / 4, Cout] fp32
// scratch), 1 narrow in (Cin 4, split 1), 2 narrow out (Cout 4, Cin a
// multiple of 4, split 1); v and ws are read by the
// general path alone. All 16-byte aligned.
// Returns a cudaError_t (0 on success); launches only.
extern "C" int winograd_conv3x3_fp32_fwd(const void* x, const void* ut, const void* bias,
                                         void* v, void* ws, void* out, int B, int H, int W,
                                         int Cin, int Cout, int Cin_p, int path, int split,
                                         void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(ut) |
                          reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(out);
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || Cin <= 0 || Cout <= 0 ||
      Cin_p != (Cin + BK - 1) / BK * BK || (align & 15) || split < 1)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * (H / 2) * (W / 2);
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* uf = static_cast<const float*>(ut);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  const int m = (int)M;
  if (path == PATH_NARROW_IN) {
    if (Cin != 4 || split != 1) return (int)cudaErrorInvalidValue;
    const int groups = (Cout + 31) / 32, cblocks = (groups + 7) / 8;
    const int warps = (groups + cblocks - 1) / cblocks;
    const size_t smem = (size_t)IN_TILES * (16 * Cin * sizeof(float) + sizeof(long long));
    const dim3 grid((unsigned)((M + IN_TILES - 1) / IN_TILES), cblocks);
    wino32_narrow_in<<<grid, 32 * warps, smem, s>>>(xf, uf, bf, of, H, W, Cout, Cin_p, m);
    return (int)cudaGetLastError();
  }
  if (path == PATH_NARROW_OUT) {
    if (Cout != 4 || Cin % 4 || split != 1 || M * TEAM >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    wino32_narrow_out<<<(unsigned)((M * TEAM + OUT_THREADS - 1) / OUT_THREADS), OUT_THREADS, 0,
                        s>>>(xf, uf, bf, of, H, W, Cin, Cin_p, m, TEAM);
    return (int)cudaGetLastError();
  }
  const int ncol = (Cout + BN - 1) / BN;
  const int vw = Cin % 4 ? 1 : 4, sw = Cout % 4 ? 1 : 4;
  if (path != PATH_GENERAL || split > MAX_SPLIT || split > 16 * Cin_p / BKS || v == nullptr ||
      (split > 1 && ws == nullptr) || (M + BM - 1) / BM * ncol * split >= (1LL << 31) ||
      M * (Cin_p / vw) >= (1LL << 31) ||
      4 * M * (Cout / sw) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  float* vf = static_cast<float*>(v);
  const long long threads = M * (Cin_p / vw);
  const unsigned tblocks = (unsigned)((threads + NT - 1) / NT);
  if (vw == 4)
    wino_input_fp32<4><<<tblocks, NT, 0, s>>>(xf, vf, H, W, Cin, Cin_p, m);
  else
    wino_input_fp32<1><<<tblocks, NT, 0, s>>>(xf, vf, H, W, Cin, Cin_p, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const GArgs g{vf, uf, bf, split > 1 ? static_cast<float*>(ws) : of, H, W, Cout, Cin_p, m,
                ncol, split};
  err = launch_product(g, s);
  if (err != cudaSuccess || split == 1) return (int)err;
  const unsigned sblocks = (unsigned)((4 * M * (Cout / sw) + NT - 1) / NT);
  if (sw == 4)
    wino32_split_sum<4><<<sblocks, NT, 0, s>>>(static_cast<const float*>(ws), bf, of, H, W, Cout,
                                               m, split);
  else
    wino32_split_sum<1><<<sblocks, NT, 0, s>>>(static_cast<const float*>(ws), bf, of, H, W, Cout,
                                               m, split);
  return (int)cudaGetLastError();
}
