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
// fp32 [B, H, Lq4]; bias fp32 [B, Lk4], where Lq4 and Lk4 are the lengths
// rounded up to 4 (pitch4: the rows of a 1-D TMA copy start 16-byte
// aligned; the pad is never read as a value); dbias_h fp32 [B, H, Lk]
// (summed over heads by the caller). bf16 in and out, fp32 accumulation.
//
// What bounds it on an H100: dq does 6*B*H*Lq*Lk*d tensor-core flops (S, dP,
// dQ), dk/dv 8*B*H*Lq*Lk*d (S, dP, dV, dK), each B*H*Lq*Lk exp2; the bytes
// (inputs and outputs once) are two orders smaller. So no [Lq, Lk] slab
// touches device memory, and the design is the forward's
// (flash_attn_packed.cu) on the building blocks of hopper_common.cuh:
//   - every product is a wgmma: the score-shaped ones (S = Q K^T, dP = dO V^T
//     in dq; S^T = K Q^T, dP^T = V dO^T in dk/dv) m64n64k16 with the streamed
//     operand K-major in shared memory and the resident one as A fragments
//     in registers where they fit (Cfg::DQ_A_REGS, DKV_A_REGS), else K-major
//     in shared memory; the D-wide ones (dQ += ds K; dV += p^T dO, dK += ds^T
//     Q) m64nDk16 with the probabilities or ds rounded to bf16 and packed
//     straight into A fragments and the shared tile read MN-major by the
//     transpose bit, so no operand is transposed in memory;
//   - operand tiles sit in wgmma's no-swizzle core-matrix layout, copied by
//     TMA (one copy per 16-byte column chunk of a head panel, so strided and
//     fused-projection operands need no staging) onto a ring with a full and
//     an empty mbarrier per stage; one thread issues the copies, and no
//     CTA-wide barrier runs per tile;
//   - tile j's score products are issued with tile j-1's D-wide products, and
//     tile j's elementwise work runs while those are on the tensor cores;
//   - dq: a CTA is two consumer warpgroups of 64 query rows (four at d40,
//     one at d160 for twice the CTAs at the UNet's L256), whose Q and dO stay
//     resident; the K/V tiles of 64 keys and their key biases ride the ring,
//     shared by all;
//   - dk/dv: a CTA is two consumer warpgroups of 64 keys, whose K and V stay
//     resident; the Q/dO tiles of 64 queries ride the ring with their lse and
//     delta (1-D TMA copies into shared memory), shared by both. dbias, when
//     asked for, sums each key row's fp32 ds in registers. At d160 the dk and dv
//     accumulators (2 x 80 fp32 registers a thread) do not fit beside the
//     score tiles, so the two warpgroups share 64 keys and split the D
//     columns of dk and dv, each computing S^T and dP^T;
//   - where the key blocks alone leave SMs idle (the cross-attention's 128
//     keys: 24 CTAs), the query loop is split over `split` CTAs per key block
//     (ops/flash_attention.py: bwd_launch_plan): each writes fp32 partials of
//     dk, dv and dbias, and a second launch sums them in slice order, so the
//     result is deterministic (no atomics).
// Register and spill counts per instance come from nvcc -Xptxas=-v.
// What was measured on the way (PERF.md, section 6): more warps an SM paid (dq at
// d40: 3 warpgroups -21%, 4 a further -2%); the elementwise work does not
// hide behind the products (without it both kernels take ~55% of their
// time); exp2 is ~10% of it; two register sets for a software-pipelined dq
// loop, and p^T / ds^T through shared memory for a third dk/dv warpgroup,
// were slower or equal with the key bias, and went.

#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int BT = 64;  // rows of a warpgroup and of a streamed tile

// The row pitch of lse, delta and the key bias: their length rounded up to
// 4 values, so that every 1-D TMA box starts 16-byte aligned.
__host__ __device__ __forceinline__ int pitch4(int n) { return (n + 3) & ~3; }

template <int D>
struct Cfg {
  // Warpgroups of 64 rows a CTA: two share each streamed tile; at d160 (the
  // UNet's L256 only) one, so that the grid has twice the CTAs.
  static constexpr int NWG = D > 80 ? 1 : 2;
  // dq: warpgroups of 64 query rows a CTA; four at d40, where they fit in
  // the 128 registers a thread of a 512-thread CTA has: more warps hide the
  // products' and exp2's latencies.
  static constexpr int DQ_NWG = D <= 40 ? 4 : NWG;
  // The score products take their resident operand (Q and dO in dq, K and
  // V in dk/dv) from registers, as wgmma A fragments, rather than shared
  // memory: half the products' shared-memory reads, DP/4 registers each,
  // where the registers allow it (dq at d40 spends them on warpgroups).
  static constexpr bool DQ_A_REGS = D > 40 && D <= 80;
  static constexpr bool DKV_A_REGS = D <= 40;
  static constexpr int DQ_ROWS = DQ_NWG * 64;
  static constexpr int DQ_THREADS = DQ_NWG * 128;
  static constexpr int STAGES = D > 80 ? 3 : 4;   // ring depth (shared memory at d160)
  static constexpr int PREFETCH = STAGES - 2;     // + the tile in use and the one behind it
  static constexpr int DP = (D + 15) / 16 * 16;   // depth of the score products
  static constexpr int CH = DP / 8;               // 16-byte chunks per staged row
  static constexpr int CD = D / 8;                // chunks a copy fills (the rest are pad)
  static constexpr int T_ELEMS = BT * DP;         // one streamed operand tile
  // dk/dv at d160: the dk and dv accumulators (2 x 80 fp32 registers a
  // thread) do not fit beside the score tiles, so two warpgroups share a
  // CTA's 64 keys, each with half of the columns (both compute S^T and dP^T).
  static constexpr bool COL_SPLIT = D > 80;
  static constexpr int DW = COL_SPLIT ? D / 2 : D;  // dk/dv columns a warpgroup owns
  // dk/dv: keys a CTA (the column halves at d160 share 64), threads
  static constexpr int DKV_ROWS = NWG * 64;
  static constexpr int DKV_THREADS = COL_SPLIT ? 256 : NWG * 128;
  // dq: Q, dO, the K and V rings, the key bias ring, barriers (full, empty
  // per stage; Q's)
  static constexpr size_t DQ_SMEM = (size_t)(2 * DQ_ROWS * DP + 2 * STAGES * T_ELEMS) *
                                        sizeof(bf16) +
                                    (size_t)STAGES * BT * sizeof(float) + (2 * STAGES + 1) * 8;
  // dk/dv: K, V, the Q and dO rings, the lse and delta rings, barriers
  static constexpr size_t DKV_SMEM = (size_t)(2 * DKV_ROWS * DP + 2 * STAGES * T_ELEMS) *
                                         sizeof(bf16) +
                                     (size_t)2 * STAGES * BT * sizeof(float) +
                                     (2 * STAGES + 1) * 8;
};

// acc = A B^T over the DP-deep rows: A is this warpgroup's 64 rows of a
// resident [CH][R][8] tile (or, with REGS, their A fragments a), B a
// streamed [CH][BT][8] tile, both K-major.
template <int DP, int R, bool REGS>
__device__ __forceinline__ void issue_scores(float (&acc)[BT / 2], const bf16* A,
                                             const uint32_t (&a)[DP / 16][4], const bf16* B) {
  const uint64_t a_desc = smem_desc(A, R * 16, 128);
  const uint64_t b_desc = smem_desc(B, BT * 16, 128);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {  // a k16 step is two chunk columns
    if constexpr (REGS)
      wgmma_rs_k<BT>(acc, a[kk], b_desc + kk * ((2 * BT * 16) >> 4), kk > 0);
    else
      wgmma_ss<BT>(acc, a_desc + kk * ((2 * R * 16) >> 4), b_desc + kk * ((2 * BT * 16) >> 4),
                   kk > 0);
  }
}

// A fragments of rows row and row + 8 (row g of a warp's 16) of a resident
// [CH][R][8] tile, for each k16 step.
template <int DP, int R>
__device__ __forceinline__ void load_frags(uint32_t (&a)[DP / 16][4], const bf16* tile, int row,
                                           int t) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const bf16* lo = tile + (2 * kk * R + row) * 8 + 2 * t;  // chunk 2kk
    const bf16* hi = lo + R * 8;                             // chunk 2kk + 1
    a[kk][0] = ld_u32(lo);
    a[kk][1] = ld_u32(lo + 64);  // row + 8
    a[kk][2] = ld_u32(hi);
    a[kk][3] = ld_u32(hi + 64);
  }
}

// acc += A T over the tile's 64 rows: A (64 x 64) from registers, T a
// streamed [CH][BT][8] tile read MN-major (its first D columns).
template <int D>
__device__ __forceinline__ void issue_wide(float (&acc)[D / 2], const uint32_t (&a)[BT / 16][4],
                                           const bf16* T) {
  const uint64_t desc = smem_desc(T, 128, BT * 16);
#pragma unroll
  for (int j = 0; j < BT / 16; ++j)  // a k16 step is two 8-row groups
    wgmma_rs<D>(acc, a[j], desc + j * (256 >> 4), 1);
}

// A score-shaped accumulator rounded to bf16 and packed in pairs: columns
// 16j..16j+15 are the A fragment of k16 step j.
__device__ __forceinline__ void pack_frags(uint32_t (&a)[BT / 16][4], const float (&x)[BT / 2]) {
#pragma unroll
  for (int i = 0; i < BT / 8; ++i) {
    a[i >> 1][(i & 1) * 2] = pack_bf16x2(x[4 * i], x[4 * i + 1]);
    a[i >> 1][(i & 1) * 2 + 1] = pack_bf16x2(x[4 * i + 2], x[4 * i + 3]);
  }
}

// The sum of the 16 values of row r (0: g, 1: g + 8) that this thread holds
// in a score-shaped accumulator, as a tree.
__device__ __forceinline__ float row_sum(const float (&x)[BT / 2], int r) {
  float a[BT / 8];
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) a[j] = x[4 * j + 2 * r] + x[4 * j + 2 * r + 1];
#pragma unroll
  for (int w = BT / 16; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) a[j] += a[j + w];
  return a[0];
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.0f;
}

// Zero the pad chunk columns [CD, CH) of `n` tiles of `rows` rows each,
// `stride` elements apart; no copy writes them, and the score products read
// them.
template <int CD, int CH>
__device__ __forceinline__ void zero_pads(bf16* tiles, int n, int rows, int stride, int tid,
                                          int nthreads) {
  if constexpr (CH > CD) {
    for (int i = tid; i < n * (CH - CD) * rows; i += nthreads) {
      const int tile = i / ((CH - CD) * rows);
      const int c = CD + (i / rows) % (CH - CD);
      *reinterpret_cast<uint4*>(tiles + tile * stride + (c * rows + i % rows) * 8) =
          make_uint4(0, 0, 0, 0);
    }
  }
}

// dq's elementwise step, in place: scores s[4i + e] (query row r = e / 2,
// key key0 + 8i + 2t + e % 2) become ds = p (dp - delta_r), p = 2^(s - lse_r).
// `bs` is the tile's 64 key biases in shared memory (read only with BIAS).
template <bool BIAS, bool RAGGED>
__device__ __forceinline__ void ds_rows(float (&s)[BT / 2], const float (&dp)[BT / 2],
                                        const float* bs, int key0, int Lk, int t, float sc_log2,
                                        const float (&lse)[2], const float (&dl)[2]) {
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const float2 b2 = BIAS ? *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t)
                           : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = key0 + 8 * j + 2 * t + c;
      const float bl = (c == 0 ? b2.x : b2.y) * LOG2E;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + c;
        float x = fmaf(s[i], sc_log2, BIAS ? bl : -lse[r]);
        if constexpr (BIAS) x = fmaxf(x, SCORE_FLOOR) - lse[r];
        float p = ex2(x);
        if (RAGGED && key >= Lk) p = 0.0f;
        s[i] = p * (dp[i] - dl[r]);
      }
    }
  }
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(Cfg<D>::DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ Panel pq, const __grid_constant__ Panel pk,
                    const __grid_constant__ Panel pv, const __grid_constant__ Panel pd,
                    const __grid_constant__ CUtensorMap mbias,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Lq, int Lk,
                    long long sdq_b, long long sdq_l, float sc_log2, float scale) {
  using T = Cfg<D>;
  constexpr int BQ = T::DQ_ROWS;
  constexpr int STAGES = T::STAGES;
  constexpr int CD = T::CD;
  // one stage's K and V copies and, with a bias, its 64 key biases
  constexpr uint32_t KV_BYTES = 2 * CD * BT * 16 + (BIAS ? BT * 4 : 0);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [CH][BQ][8]
  bf16* Ds = Qs + BQ * T::DP;                     // [CH][BQ][8] dO
  bf16* Ks = Ds + BQ * T::DP;                     // [STAGES][CH][BT][8]
  bf16* Vs = Ks + STAGES * T::T_ELEMS;            // [STAGES][CH][BT][8]
  float* Bs = reinterpret_cast<float*>(Vs + STAGES * T::T_ELEMS);  // [STAGES][BT] key bias
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * BT);  // [STAGES]
  uint64_t* empty = full + STAGES;                                          // [STAGES]
  uint64_t* q_full = empty + STAGES;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nkt = (Lk + BT - 1) / BT;

  // K, V (and the key bias) of tile j into stage j % STAGES, once every warp
  // has released that stage's previous tile (j - STAGES).
  auto load_kv = [&](int j) {
    const int st = j % STAGES;
    if (j >= STAGES) mbar_wait(&empty[st], ((j / STAGES) + 1) & 1);
    mbar_arrive_expect_tx(&full[st], KV_BYTES);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      tma_load_3d(Ks + st * T::T_ELEMS + c * BT * 8, &pk.map, h * D + 8 * c, j * BT,
                  b * pk.batched, &full[st]);
      tma_load_3d(Vs + st * T::T_ELEMS + c * BT * 8, &pv.map, h * D + 8 * c, j * BT,
                  b * pv.batched, &full[st]);
    }
    if constexpr (BIAS) tma_load_1d(Bs + st * BT, &mbias, b * pitch4(Lk) + j * BT, &full[st]);
  };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], T::DQ_NWG * 4);  // lane 0 of every warp
    }
    mbar_init(q_full, 1);
    fence_mbar_init();
  }
  zero_pads<CD, T::CH>(Qs, 2, BQ, BQ * T::DP, tid, T::DQ_THREADS);            // Q, dO
  zero_pads<CD, T::CH>(Ks, 2 * STAGES, BT, T::T_ELEMS, tid, T::DQ_THREADS);   // K, V
  fence_proxy_async();  // the zeros, for wgmma
  __syncthreads();      // and the barriers, for everyone
  if (tid == 0) {
    mbar_arrive_expect_tx(q_full, 2 * CD * BQ * 16);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      tma_load_3d(Qs + c * BQ * 8, &pq.map, h * D + 8 * c, q0, b * pq.batched, q_full);
      tma_load_3d(Ds + c * BQ * 8, &pd.map, h * D + 8 * c, q0, b * pd.batched, q_full);
    }
    for (int j = 0; j < T::PREFETCH && j < nkt; ++j) load_kv(j);
  }

  // this thread's query rows row0 and row0 + 8
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  const long long stat0 = ((long long)b * gridDim.y + h) * pitch4(Lq);
  float row_lse[2], row_dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    row_lse[r] = row < Lq ? lse[stat0 + row] : 0.0f;
    row_dl[r] = row < Lq ? delta[stat0 + row] : 0.0f;
  }

  float acc[D / 2];
  zero(acc);
  float s[BT / 2], dp[BT / 2];
  uint32_t da[BT / 16][4];
  const bf16* Qw = Qs + wg * 64 * 8;
  const bf16* Dw = Ds + wg * 64 * 8;
  uint32_t qa[T::DP / 16][4], doa[T::DP / 16][4];  // their A fragments, under DQ_A_REGS
  mbar_wait(q_full, 0);
  if constexpr (T::DQ_A_REGS) {
    load_frags<T::DP, BQ>(qa, Qs, wg * 64 + warp * 16 + g, t);
    load_frags<T::DP, BQ>(doa, Ds, wg * 64 + warp * 16 + g, t);
  }

  // Tile kt's S and dP are issued with tile kt-1's dQ += ds K; tile kt's ds
  // is computed while that runs; then the warp releases tile kt-1's stage.
  for (int kt = 0; kt < nkt; ++kt) {
    if (tid == 0 && kt + T::PREFETCH < nkt) load_kv(kt + T::PREFETCH);
    const int st = kt % STAGES;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    __syncwarp();  // wgmma wants the warp converged

    if (kt > 0) pack_frags(da, s);
    fence_regs(acc);
    wgmma_fence();
    issue_scores<T::DP, BQ, T::DQ_A_REGS>(s, Qw, qa, Ks + st * T::T_ELEMS);
    issue_scores<T::DP, BQ, T::DQ_A_REGS>(dp, Dw, doa, Vs + st * T::T_ELEMS);
    wgmma_commit();
    if (kt > 0) {
      issue_wide<D>(acc, da, Ks + ((kt - 1) % STAGES) * T::T_ELEMS);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    fence_regs(dp);
    if (kt * BT + BT <= Lk)
      ds_rows<BIAS, false>(s, dp, Bs + st * BT, kt * BT, Lk, t, sc_log2, row_lse, row_dl);
    else
      ds_rows<BIAS, true>(s, dp, Bs + st * BT, kt * BT, Lk, t, sc_log2, row_lse, row_dl);
    if (kt > 0) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
  }
  if (nkt > 0) {  // the last tile's dQ += ds K
    pack_frags(da, s);
    fence_regs(acc);
    wgmma_fence();
    issue_wide<D>(acc, da, Ks + ((nkt - 1) % STAGES) * T::T_ELEMS);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  bf16* out = dq + b * sdq_b + (long long)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < Lq) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(out + row * sdq_l + 8 * i + 2 * t) =
            pack_bf16x2(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
    }
  }
}

// dk/dv's elementwise step, in place: scores st[4i + e] (key row r = e / 2,
// query column qbase + 8i + 2t + e % 2) become p^T = 2^(s - lse) and dpt
// becomes ds^T = p^T (dP^T - delta). `ls` and `dl` are the tile's 64 lse and
// delta values in shared memory, `rb` the rows' bias * log2(e); with RAGGED
// (the last tile of a ragged Lq) queries past Lq contribute nothing.
template <bool BIAS, bool RAGGED>
__device__ __forceinline__ void p_ds_cols(float (&st)[BT / 2], float (&dpt)[BT / 2],
                                          const float* ls, const float* dl,
                                          const float (&rb)[2], int qbase, int Lq, int t,
                                          float sc_log2) {
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float l = c == 0 ? l2.x : l2.y;
      const float dlt = c == 0 ? d2.x : d2.y;
      const bool valid = !RAGGED || qbase + 8 * j + 2 * t + c < Lq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 4 * j + 2 * r + c;
        float x = fmaf(st[e], sc_log2, BIAS ? rb[r] : -l);
        if constexpr (BIAS) x = fmaxf(x, SCORE_FLOOR) - l;
        const float p = valid ? ex2(x) : 0.0f;
        st[e] = p;
        dpt[e] = valid ? p * (dpt[e] - dlt) : 0.0f;
      }
    }
  }
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(Cfg<D>::DKV_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ Panel pq, const __grid_constant__ Panel pk,
                     const __grid_constant__ Panel pv, const __grid_constant__ Panel pd,
                     const __grid_constant__ CUtensorMap mlse,
                     const __grid_constant__ CUtensorMap mdelta,
                     const float* __restrict__ bias, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float* __restrict__ dbias, float* __restrict__ ws,
                     int Lq, int Lk, int split, long long sdk_b, long long sdk_l,
                     long long sdv_b, long long sdv_l, float sc_log2, float scale) {
  using T = Cfg<D>;
  constexpr int BK = T::DKV_ROWS;
  constexpr int STAGES = T::STAGES;
  constexpr int CD = T::CD;
  constexpr int DW = T::DW;
  // one stage: the Q and dO copies, and 64 lse and delta values
  constexpr uint32_t STAGE_BYTES = 2 * CD * BT * 16 + 2 * BT * 4;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [CH][BK][8]
  bf16* Vs = Ks + BK * T::DP;                     // [CH][BK][8]
  bf16* Qr = Vs + BK * T::DP;                     // [STAGES][CH][BT][8]
  bf16* Dr = Qr + STAGES * T::T_ELEMS;            // [STAGES][CH][BT][8] dO
  float* Lr = reinterpret_cast<float*>(Dr + STAGES * T::T_ELEMS);  // [STAGES][BT] lse
  float* Dlr = Lr + STAGES * BT;                                   // [STAGES][BT] delta
  uint64_t* full = reinterpret_cast<uint64_t*>(Dlr + STAGES * BT);  // [STAGES]
  uint64_t* empty = full + STAGES;                                   // [STAGES]
  uint64_t* kv_full = empty + STAGES;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int B = gridDim.z;
  const int kb = blockIdx.x / split;  // key block
  const int sl = blockIdx.x % split;  // query slice
  const int k0 = kb * BK;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int kw = T::COL_SPLIT ? 0 : wg;  // this warpgroup's 64 keys
  const int col0 = T::COL_SPLIT ? wg * DW : 0;  // and its dk/dv columns [col0, col0 + DW)
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int nqt = (Lq + BT - 1) / BT;
  const int qt0 = sl * nqt / split;
  const int n = (sl + 1) * nqt / split - qt0;
  const long long stat0 = ((long long)b * H + h) * pitch4(Lq);

  // Q, dO, lse and delta of query tile qt0 + j into stage j % STAGES, once
  // every warp has released that stage's previous tile (j - STAGES).
  auto load_q = [&](int j) {
    const int st = j % STAGES;
    const int qt = qt0 + j;
    if (j >= STAGES) mbar_wait(&empty[st], ((j / STAGES) + 1) & 1);
    mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      tma_load_3d(Qr + st * T::T_ELEMS + c * BT * 8, &pq.map, h * D + 8 * c, qt * BT,
                  b * pq.batched, &full[st]);
      tma_load_3d(Dr + st * T::T_ELEMS + c * BT * 8, &pd.map, h * D + 8 * c, qt * BT,
                  b * pd.batched, &full[st]);
    }
    tma_load_1d(Lr + st * BT, &mlse, (int)(stat0 + qt * BT), &full[st]);
    tma_load_1d(Dlr + st * BT, &mdelta, (int)(stat0 + qt * BT), &full[st]);
  };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], T::DKV_THREADS / 32);  // lane 0 of every warp
    }
    mbar_init(kv_full, 1);
    fence_mbar_init();
  }
  zero_pads<CD, T::CH>(Ks, 2, BK, BK * T::DP, tid, T::DKV_THREADS);            // K, V
  zero_pads<CD, T::CH>(Qr, 2 * STAGES, BT, T::T_ELEMS, tid, T::DKV_THREADS);   // Q, dO
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(kv_full, 2 * CD * BK * 16);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      tma_load_3d(Ks + c * BK * 8, &pk.map, h * D + 8 * c, k0, b * pk.batched, kv_full);
      tma_load_3d(Vs + c * BK * 8, &pv.map, h * D + 8 * c, k0, b * pv.batched, kv_full);
    }
    for (int j = 0; j < T::PREFETCH && j < n; ++j) load_q(j);
  }

  // this thread's key rows: row and row + 8 of the resident tile
  const int row = kw * 64 + warp * 16 + (lane >> 2);
  float row_bias[2];  // their bias * log2(e)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row + 8 * r;
    row_bias[r] = BIAS && key < Lk ? bias[(long long)b * pitch4(Lk) + key] * LOG2E : 0.0f;
  }
  const bf16* Kw = Ks + kw * 64 * 8;
  const bf16* Vw = Vs + kw * 64 * 8;
  float acc_v[DW / 2], acc_k[DW / 2];
  zero(acc_v);
  zero(acc_k);
  const bool want_db = dbias != nullptr;
  float db[2] = {0.0f, 0.0f};  // this thread's partial dbias of its two key rows
  float st_[BT / 2], dpt[BT / 2];
  uint32_t pa[BT / 16][4], da[BT / 16][4];
  uint32_t ka[T::DP / 16][4], va[T::DP / 16][4];  // K and V A fragments, under DKV_A_REGS
  mbar_wait(kv_full, 0);
  if constexpr (T::DKV_A_REGS) {
    load_frags<T::DP, BK>(ka, Ks, row, t);
    load_frags<T::DP, BK>(va, Vs, row, t);
  }
  // dV += p^T dO and dK += ds^T Q on ring stage st, p^T and ds^T rounded to
  // bf16 and packed as A fragments (pa, da)
  auto issue_dkv = [&](int st) {
    issue_wide<DW>(acc_v, pa, Dr + st * T::T_ELEMS + col0 * BT);
    issue_wide<DW>(acc_k, da, Qr + st * T::T_ELEMS + col0 * BT);
  };

  // Tile j's S^T and dP^T are issued with tile j-1's dV += p^T dO and dK +=
  // ds^T Q; tile j's p and ds are computed while those run; then the warp
  // releases tile j-1's stage.
  for (int j = 0; j < n; ++j) {
    if (tid == 0 && j + T::PREFETCH < n) load_q(j + T::PREFETCH);
    const int st = j % STAGES;
    mbar_wait(&full[st], (j / STAGES) & 1);
    __syncwarp();

    if (j > 0) {
      pack_frags(pa, st_);
      pack_frags(da, dpt);
    }
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
    issue_scores<T::DP, BK, T::DKV_A_REGS>(st_, Kw, ka, Qr + st * T::T_ELEMS);  // K Q^T
    issue_scores<T::DP, BK, T::DKV_A_REGS>(dpt, Vw, va, Dr + st * T::T_ELEMS);  // V dO^T
    wgmma_commit();
    if (j > 0) {
      issue_dkv((j - 1) % STAGES);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(st_);
    fence_regs(dpt);

    const int qbase = (qt0 + j) * BT;
    if (qbase + BT <= Lq)
      p_ds_cols<BIAS, false>(st_, dpt, Lr + st * BT, Dlr + st * BT, row_bias, qbase, Lq, t,
                             sc_log2);
    else
      p_ds_cols<BIAS, true>(st_, dpt, Lr + st * BT, Dlr + st * BT, row_bias, qbase, Lq, t,
                            sc_log2);
    if (want_db) {
      db[0] += row_sum(dpt, 0);
      db[1] += row_sum(dpt, 1);
    }
    if (j > 0) {
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      if (lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
    }
  }
  if (n > 0) {  // the last tile's dV and dK products
    pack_frags(pa, st_);
    pack_frags(da, dpt);
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
    issue_dkv((n - 1) % STAGES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
  }

  // The results of this thread's key rows: bf16 into dk (times scale) and
  // dv, fp32 into dbias; or, under a split, fp32 partials into slice sl's
  // part of ws = [dk | dv][split][B][H][Lk][D], then dbias [split][B][H][Lk].
  // Accumulator value 4i + 2r + e is key row row + 8r, column col0 + 8i +
  // 2t + e.
  const long long part = (long long)B * H * Lk * D;
  const long long head = ((long long)sl * B + b) * H + h;
  bf16* dkp = dk + b * sdk_b + (long long)h * D + col0;
  bf16* dvp = dv + b * sdv_b + (long long)h * D + col0;
  float* wsk = ws + head * Lk * D + col0;
  float* wsv = wsk + split * part;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row + 8 * r;
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
    if (key >= Lk) continue;
#pragma unroll
    for (int i = 0; i < DW / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (split > 1) {
        *reinterpret_cast<float2*>(wsv + (long long)key * D + col) =
            make_float2(acc_v[4 * i + 2 * r], acc_v[4 * i + 2 * r + 1]);
        *reinterpret_cast<float2*>(wsk + (long long)key * D + col) =
            make_float2(acc_k[4 * i + 2 * r], acc_k[4 * i + 2 * r + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(dvp + key * sdv_l + col) =
            pack_bf16x2(acc_v[4 * i + 2 * r], acc_v[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dkp + key * sdk_l + col) =
            pack_bf16x2(acc_k[4 * i + 2 * r] * scale, acc_k[4 * i + 2 * r + 1] * scale);
      }
    }
    if (want_db && t == 0 && col0 == 0) {  // one column half writes dbias
      if (split > 1)
        ws[2 * split * part + head * Lk + key] = db[r];
      else
        dbias[((long long)b * H + h) * Lk + key] = db[r];
    }
  }
}

// The split's second launch: dk, dv and dbias as the fp32 sums of the
// slices' partials, taken in slice order (dk times scale), so two launches
// agree bit for bit.
__global__ void dkv_sum_kernel(const float* __restrict__ ws, int split, int B, int H, int Lk,
                               int D, bf16* __restrict__ dk, bf16* __restrict__ dv,
                               float* __restrict__ dbias, long long sdk_b, long long sdk_l,
                               long long sdv_b, long long sdv_l, float scale) {
  const long long part = (long long)B * H * Lk * D;
  const long long nb = (long long)B * H * Lk;
  const long long n = part + (dbias == nullptr ? 0 : nb);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < part) {
      const int col = (int)(i % D);
      const int key = (int)(i / D % Lk);
      const long long bh = i / ((long long)D * Lk);
      const int h = (int)(bh % H);
      const int b = (int)(bh / H);
      float sk = 0.0f, sv = 0.0f;
      for (int s = 0; s < split; ++s) {
        sk += ws[s * part + i];
        sv += ws[(split + s) * part + i];
      }
      dk[b * sdk_b + key * sdk_l + (long long)h * D + col] = __float2bfloat16_rn(sk * scale);
      dv[b * sdv_b + key * sdv_l + (long long)h * D + col] = __float2bfloat16_rn(sv);
    } else {
      const long long k = i - part;
      float sb = 0.0f;
      for (int s = 0; s < split; ++s) sb += ws[2 * split * part + s * nb + k];
      dbias[k] = sb;
    }
  }
}

// The tensor maps of q, k, v and dO (st: their batch and row strides), with
// boxes of q_rows query rows and k_rows keys.
int make_panels(Panel (&p)[4], const void* q, const void* k, const void* v, const void* dout,
                int B, int H, int Lq, int Lk, int D, const long long* st, int q_rows,
                int k_rows) {
  const void* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const bool is_q = i == 0 || i == 3;
    p[i].batched = st[2 * i] != 0;
    if (make_panel_map(&p[i].map, bases[i], H * D, is_q ? Lq : Lk, B, st[2 * i + 1], st[2 * i],
                       is_q ? q_rows : k_rows) != 0)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int D, bool BIAS>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* bias, void* dq, int B, int H, int Lq, int Lk,
              const long long* st, float sc_log2, float scale, cudaStream_t stream) {
  using T = Cfg<D>;
  static const cudaError_t attr_err = allow_smem(flash_bwd_dq_kernel<D, BIAS>, T::DQ_SMEM);
  if (attr_err != cudaSuccess) return (int)attr_err;
  Panel p[4];
  if (const int err = make_panels(p, q, k, v, dout, B, H, Lq, Lk, D, st, T::DQ_ROWS, BT))
    return err;
  CUtensorMap mbias = {};
  if (BIAS && make_vec_map(&mbias, bias, (long long)B * pitch4(Lk), BT) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Lq + T::DQ_ROWS - 1) / T::DQ_ROWS, H, B);
  flash_bwd_dq_kernel<D, BIAS><<<grid, T::DQ_THREADS, T::DQ_SMEM, stream>>>(
      p[0], p[1], p[2], p[3], mbias, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Lq, Lk, st[8], st[9], sc_log2,
      scale);
  return (int)cudaGetLastError();
}

template <int D, bool BIAS>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* bias, void* dk, void* dv, void* dbias, int B,
               int H, int Lq, int Lk, const long long* st, float sc_log2, float scale,
               int split, void* ws, cudaStream_t stream) {
  using T = Cfg<D>;
  static const cudaError_t attr_err = allow_smem(flash_bwd_dkv_kernel<D, BIAS>, T::DKV_SMEM);
  if (attr_err != cudaSuccess) return (int)attr_err;
  Panel p[4];
  if (const int err = make_panels(p, q, k, v, dout, B, H, Lq, Lk, D, st, BT, T::DKV_ROWS))
    return err;
  CUtensorMap mlse, mdelta;
  if (make_vec_map(&mlse, lse, (long long)B * H * pitch4(Lq), BT) != 0 ||
      make_vec_map(&mdelta, delta, (long long)B * H * pitch4(Lq), BT) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Lk + T::DKV_ROWS - 1) / T::DKV_ROWS * split, H, B);
  flash_bwd_dkv_kernel<D, BIAS><<<grid, T::DKV_THREADS, T::DKV_SMEM, stream>>>(
      p[0], p[1], p[2], p[3], mlse, mdelta, static_cast<const float*>(bias),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dbias),
      static_cast<float*>(ws), Lq, Lk, split, st[8], st[9], st[10], st[11], sc_log2, scale);
  if (split == 1) return (int)cudaGetLastError();
  if (const cudaError_t err = cudaGetLastError()) return (int)err;
  const long long n = (long long)B * H * Lk * (D + 1);
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  dkv_sum_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws), split, B, H, Lk, D, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dbias), st[8], st[9], st[10], st[11], scale);
  return (int)cudaGetLastError();
}

template <int D>
int dq_bias(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, const void* bias, void* dq, int B, int H, int Lq, int Lk,
            const long long* st, float sc_log2, float scale, cudaStream_t s) {
  return bias != nullptr ? launch_dq<D, true>(q, k, v, dout, lse, delta, bias, dq, B, H, Lq, Lk,
                                              st, sc_log2, scale, s)
                         : launch_dq<D, false>(q, k, v, dout, lse, delta, bias, dq, B, H, Lq,
                                               Lk, st, sc_log2, scale, s);
}

template <int D>
int dkv_bias(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, const void* bias, void* dk, void* dv, void* dbias, int B, int H,
             int Lq, int Lk, const long long* st, float sc_log2, float scale, int split,
             void* ws, cudaStream_t s) {
  return bias != nullptr
             ? launch_dkv<D, true>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk,
                                   st, sc_log2, scale, split, ws, s)
             : launch_dkv<D, false>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq,
                                    Lk, st, sc_log2, scale, split, ws, s);
}

}  // namespace

// Built for the UNet's head dims 40, 80 and 160. `strides` holds the batch
// and row strides, in elements, of q, k, v, dO, dq (10 values). `bias` may be
// null. lse, delta and bias are 16-byte aligned, with rows of pitch4(Lq) and
// pitch4(Lk) values. Returns a cudaError_t value (0 on success).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* bias, void* dq, int B, int H, int Lq,
                                 int Lk, int D, const long long* strides,
                                 float sc_log2, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return dq_bias<40>(q, k, v, dout, lse, delta, bias, dq, B, H, Lq, Lk, strides, sc_log2,
                         scale, s);
    case 80:
      return dq_bias<80>(q, k, v, dout, lse, delta, bias, dq, B, H, Lq, Lk, strides, sc_log2,
                         scale, s);
    case 160:
      return dq_bias<160>(q, k, v, dout, lse, delta, bias, dq, B, H, Lq, Lk, strides, sc_log2,
                          scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// `strides` holds the batch and row strides of q, k, v, dO, dk, dv (12
// values). `bias` and `dbias` may be null. `split` (1 .. the query tiles of
// 64) splits the query loop over that many CTAs per key block; above 1, `ws`
// is fp32 scratch of split * B * H * Lk * (2 * D + 1) values for their
// partials. The layouts of lse, delta and bias are dq's.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  const void* bias, void* dk, void* dv, void* dbias,
                                  int B, int H, int Lq, int Lk, int D,
                                  const long long* strides, float sc_log2, float scale,
                                  int split, void* ws, void* stream) {
  if (split < 1 || split > (Lq + BT - 1) / BT || (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return dkv_bias<40>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk,
                          strides, sc_log2, scale, split, ws, s);
    case 80:
      return dkv_bias<80>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk,
                          strides, sc_log2, scale, split, ws, s);
    case 160:
      return dkv_bias<160>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk,
                           strides, sc_log2, scale, split, ws, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The rows one CTA owns at head dim D: query rows of `flash_attn_bwd_dq`
// (dkv == 0; grid (ceil(Lq / rows), H, B)) or keys of `flash_attn_bwd_dkv`
// (grid (ceil(Lk / rows) * split, H, B)). -1 for a D it is not built for.
extern "C" int flash_attn_bwd_rows(int D, int dkv) {
  switch (D) {
    case 40:
      return dkv ? Cfg<40>::DKV_ROWS : Cfg<40>::DQ_ROWS;
    case 80:
      return dkv ? Cfg<80>::DKV_ROWS : Cfg<80>::DQ_ROWS;
    case 160:
      return dkv ? Cfg<160>::DKV_ROWS : Cfg<160>::DQ_ROWS;
    default:
      return -1;
  }
}
