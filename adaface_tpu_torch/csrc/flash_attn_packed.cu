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
// the work is 4*B*H*Lq*Lk*d tensor-core flops plus B*H*Lq*Lk exp2 on the
// special-function units (MUFU, 16 per clock per SM), and the bytes (q, k, v,
// o once) are two orders smaller; at d40 the exp2 count is the larger bound.
// The design:
//   - a CTA is four consumer warpgroups of 64 query rows (BQ = 256) where 128
//     registers a thread suffice (d40, d80), else two (BQ = 128: d160, a key
//     bias, K1's flags); all of them share each staged K/V tile, so the K/V
//     bytes moved per query row fall with BQ; grid (ceil(Lq/BQ), H, B);
//   - Q [BQ, DP] and a four-stage ring of K/V tiles [64, DP] (DP = D rounded
//     up to 16, pad columns zeroed once) sit in shared memory in wgmma's
//     no-swizzle core-matrix layout. TMA copies them (one copy per 16-byte
//     column chunk of a head panel, so strided and fused-projection operands
//     need no staging), two tiles ahead; each stage has a full mbarrier (the
//     copies' bytes) and an empty one (every warp's release after its P V), so
//     no CTA-wide barrier or proxy fence runs per tile and one thread issues
//     all copies;
//   - S = Q K^T is one wgmma m64n64k16 chain per warpgroup over DP/16 steps,
//     K from shared memory, Q from registers at d40 (halving the product's
//     shared-memory reads) and from shared memory otherwise; O += P V is a
//     wgmma m64nDk16 chain with P from registers (the S accumulator rounded
//     to bf16 and packed in pairs is wgmma's A fragment) and V read MN-major
//     with the transpose bit;
//   - tile j's Q K^T is issued with tile j-1's P V, and tile j's softmax runs
//     while that P V is on the tensor cores;
//   - the softmax is specialised at compile time on the key bias, the flags
//     and the ragged last tile: per score one FFMA (s * scale - m) and one
//     ex2.approx.ftz, the row maximum and sum as trees; O and l are rescaled
//     only when a row maximum of the warp moved.
// What was measured on the way (PERF.md, PR 6): the K/V bytes per query row
// and the products' shared-memory reads bound it; MUFU is a minor part
// (replacing exp2 by a move saves under 10%), the copies' latency none.

#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int WG_ROWS = 64;          // query rows per warpgroup (wgmma M)
constexpr int BK = 64;               // keys per K/V tile (N of Q K^T)
constexpr int PREFETCH = 2;          // K/V tiles in flight ahead of the one in use
constexpr int STAGES = PREFETCH + 2; // K/V ring: + the tile in use and the one P V reads
constexpr int FLAG_EXP_BF16 = 1;
constexpr int FLAG_MXU_SUM = 2;

template <int D, int FLAGS, bool BIAS>
struct Cfg {
  // Q K^T takes Q from registers (wgmma A fragments, DP/8 registers) rather
  // than shared memory, halving the product's shared-memory reads; only the
  // d40 instance without a bias or a flag has the registers.
  static constexpr bool Q_REGS = D <= 40 && FLAGS == 0 && !BIAS;
  // Four consumer warpgroups (BQ = 256 query rows) share each K/V tile where
  // 128 registers a thread suffice: d40 and d80 without a key bias or K1's
  // flags. The others run two (BQ = 128) at one CTA per SM.
  static constexpr int NWG = D <= 80 && FLAGS == 0 && !BIAS ? 4 : 2;
  static constexpr int BQ = NWG * WG_ROWS;
  static constexpr int NTHREADS = NWG * 128;
  static constexpr int DP = (D + 15) / 16 * 16;  // depth of Q K^T, k16 steps
  static constexpr int CH = DP / 8;              // 16-byte chunks per staged row
  static constexpr int Q_ELEMS = BQ * DP;
  static constexpr int KV_ELEMS = BK * DP;
  // Q, the K and V rings, then the mbarriers: full and empty per stage, Q's.
  static constexpr size_t SMEM =
      (size_t)(Q_ELEMS + 2 * STAGES * KV_ELEMS) * sizeof(bf16) + (2 * STAGES + 1) * 8;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 2^n for an integer-valued n <= 0, exact; 0 below the normal range.
__device__ __forceinline__ float exp2_int(float n) {
  const int e = (int)n;
  return e < -126 ? 0.0f : __int_as_float((e + 127) << 23);
}

// S = Q K^T for a warpgroup's 64 rows and a tile's BK keys: DP/16 k16 steps,
// K K-major in shared memory; Q either in registers as wgmma A fragments (qa,
// Q_REGS) or K-major in shared memory (q_desc).
template <int DP, int BQ, bool Q_REGS>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2], uint64_t q_desc,
                                             const uint32_t (&qa)[DP / 16][4],
                                             const bf16* Kt) {
  const uint64_t k_desc = smem_desc(Kt, BK * 16, 128);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {  // a k16 step is two chunk columns
    if constexpr (Q_REGS)
      wgmma_rs_k<BK>(s, qa[kk], k_desc + kk * ((2 * BK * 16) >> 4), kk > 0);
    else
      wgmma_ss<BK>(s, q_desc + kk * ((2 * BQ * 16) >> 4), k_desc + kk * ((2 * BK * 16) >> 4),
                   kk > 0);
  }
}

// A fragments of this thread's Q rows (row, row + 8: row g of its warp's 16)
// for each k16 step, from the staged [CH][BQ][8] tile.
template <int DP, int BQ>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[DP / 16][4], const bf16* Qs,
                                             int row, int t) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const bf16* lo = Qs + (2 * kk * BQ + row) * 8 + 2 * t;  // chunk 2kk
    const bf16* hi = lo + BQ * 8;                           // chunk 2kk + 1
    qa[kk][0] = ld_u32(lo);
    qa[kk][1] = ld_u32(lo + 64);  // row + 8
    qa[kk][2] = ld_u32(hi);
    qa[kk][3] = ld_u32(hi + 64);
  }
}

// Maximum and sum over the 16 values of row r (0: g, 1: g + 8) that this
// thread holds, as trees of depth 4 rather than chains of 16.
__device__ __forceinline__ float row_max(const float (&s)[BK / 2], int r) {
  float m[BK / 8];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) m[j] = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
#pragma unroll
  for (int w = BK / 16; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) m[j] = fmaxf(m[j], m[j + w]);
  return m[0];
}

__device__ __forceinline__ float row_sum(const float (&s)[BK / 2], int r) {
  float a[BK / 8];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) a[j] = s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
#pragma unroll
  for (int w = BK / 16; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) a[j] += a[j + w];
  return a[0];
}

// O += P V: BK/16 k16 steps, P from registers, V MN-major in shared memory.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const bf16* Vt) {
  const uint64_t v_desc = smem_desc(Vt, 128, BK * 16);
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)  // a k16 step is two 8-key groups
    wgmma_rs<D>(acc, pa[j], v_desc + j * (256 >> 4), 1);
}

// The probabilities of a tile, rounded to bf16 and packed in pairs: the
// S accumulator layout of keys 16j..16j+15 is the A fragment of k16 step j.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&p)[BK / 2]) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    pa[i >> 1][(i & 1) * 2] = pack_bf16x2(p[4 * i], p[4 * i + 1]);
    pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16x2(p[4 * i + 2], p[4 * i + 3]);
  }
}

// Multiply rows g (r = 0) and g + 8 (r = 1) of an accumulator by corr[r].
template <int N>
__device__ __forceinline__ void rescale_rows(float (&acc)[N], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    acc[i] *= corr[0];
    acc[i + 1] *= corr[0];
    acc[i + 2] *= corr[1];
    acc[i + 3] *= corr[1];
  }
}

// Online softmax of one tile, in place: scores s[4i + e] (row g + 8 * (e /
// 2), key key0 + 8i + 2t + e % 2) become p = 2^(x - m) with the updated
// running maximum m; the running sums take their rescale and the tile's p.
// `bp` is the batch's key bias in device memory (read for this thread's 16
// keys, through L1). Returns whether O needs the rescale corr (false when no
// row maximum of the warp moved; corr is then 1).
template <int FLAGS, bool BIAS, bool RAGGED>
__device__ __forceinline__ bool softmax_tile(float (&s)[BK / 2], const float* bp, int key0,
                                             int Lk, int t, float mul,
                                             float sc_log2, bool flag_lse, float (&m_run)[2],
                                             float (&l_run)[2], float (&l_lse)[2],
                                             float (&corr)[2]) {
  constexpr int NS = BK / 2;
  if constexpr (BIAS || FLAGS != 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x = s[i] * sc_log2;
      if constexpr (BIAS) {
        const int key = key0 + 8 * (i / 4) + 2 * t + (i & 1);
        x = fmaxf(x + (RAGGED && key >= Lk ? 0.0f : __ldg(bp + key)) * LOG2E, SCORE_FLOOR);
      }
      s[i] = x;
    }
  }
  if constexpr (RAGGED) {  // the last tile of a ragged Lk: keys past Lk
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (key0 + 8 * (i / 4) + 2 * t + (i & 1) >= Lk) s[i] = -INFINITY;
  }
  float mx[2] = {row_max(s, 0), row_max(s, 1)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  float msub[2];
  bool moved = true;
  if constexpr (FLAGS == 0) {
    // Key 0 is in the first tile, so the maximum is finite from then on
    // and corr = 2^(-inf) = 0 only there.
    bool mine = false;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      msub[r] = fmaxf(m_run[r], mx[r] * mul);
      mine |= msub[r] != m_run[r];
    }
    moved = __any_sync(0xffffffffu, mine);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      corr[r] = moved ? ex2(m_run[r] - msub[r]) : 1.0f;
      l_run[r] *= corr[r];
      m_run[r] = msub[r];
    }
  } else {  // an integer shift, so that every rescale is exact
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      msub[r] = mx[r] == -INFINITY ? 0.0f : ceilf(mx[r]);
      corr[r] = m_run[r] == -INFINITY ? 0.0f : exp2_int(m_run[r] - msub[r]);
      m_run[r] = mx[r] == -INFINITY ? -INFINITY : msub[r];
      l_lse[r] *= corr[r];
      l_run[r] *= corr[r];
    }
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float m = msub[(i >> 1) & 1];
    float p;
    if constexpr (FLAGS == 0) {
      p = ex2(fmaf(s[i], mul, -m));
    } else {
      const float x = s[i];
      if constexpr ((FLAGS & FLAG_EXP_BF16) != 0) {
        p = round_bf16(ex2(round_bf16(x) - m));
      } else {
        p = ex2(x - m);
      }
      // (under EXP_BF16 p is a bf16 value already)
      l_run[(i >> 1) & 1] += FLAGS == FLAG_MXU_SUM ? round_bf16(p) : p;
      if (flag_lse) l_lse[(i >> 1) & 1] += ex2(x - m);
    }
    s[i] = p;
  }
  if constexpr (FLAGS == 0) {
    l_run[0] += row_sum(s, 0);
    l_run[1] += row_sum(s, 1);
  }
  return moved;
}

template <int D, int FLAGS, bool BIAS>
__global__ void __launch_bounds__(Cfg<D, FLAGS, BIAS>::NTHREADS, 1)
flash_fwd_packed_kernel(const __grid_constant__ Panel pq, const __grid_constant__ Panel pk,
                        const __grid_constant__ Panel pv, const float* __restrict__ bias,
                        bf16* __restrict__ o, float* __restrict__ lse, int Lq, int Lk,
                        long long so_b, long long so_l, float sc_log2) {
  using T = Cfg<D, FLAGS, BIAS>;
  constexpr int NWG = T::NWG;
  constexpr int BQ = T::BQ;
  constexpr int NTHREADS = T::NTHREADS;
  constexpr int DP = T::DP;
  constexpr int CH = T::CH;
  constexpr int CD = D / 8;   // chunk columns a copy fills (the rest are pad)
  constexpr int NS = BK / 2;  // S accumulator values per thread
  constexpr int NO = D / 2;   // O accumulator values per thread
  constexpr uint32_t KV_BYTES = 2 * CD * BK * 16;  // one stage's K and V copies

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [CH][BQ][8]
  bf16* Ks = Qs + T::Q_ELEMS;                     // [STAGES][CH][BK][8]
  bf16* Vs = Ks + STAGES * T::KV_ELEMS;           // [STAGES][CH][BK][8]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * T::KV_ELEMS);  // [STAGES]
  uint64_t* empty = full + STAGES;                                           // [STAGES]
  uint64_t* q_full = empty + STAGES;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int t = lane & 3;   // column pair within an 8-column block
  const int nkt = (Lk + BK - 1) / BK;
  const float* bp = BIAS ? bias + (long long)b * Lk : nullptr;

  // Thread 0 issues every copy: K and V of tile j into ring stage j % STAGES,
  // once every warp has released that stage's previous tile (j - STAGES).
  auto load_kv = [&](int j) {
    const int st = j % STAGES;
    if (j >= STAGES) mbar_wait(&empty[st], ((j / STAGES) + 1) & 1);
    mbar_arrive_expect_tx(&full[st], KV_BYTES);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      tma_load_3d(Ks + st * T::KV_ELEMS + c * BK * 8, &pk.map, h * D + 8 * c, j * BK,
                  b * pk.batched, &full[st]);
      tma_load_3d(Vs + st * T::KV_ELEMS + c * BK * 8, &pv.map, h * D + 8 * c, j * BK,
                  b * pv.batched, &full[st]);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NWG * 4);  // lane 0 of each warp of every warpgroup
    }
    mbar_init(q_full, 1);
    fence_mbar_init();
  }
  // Zero the pad chunk columns of Q and of each K stage once (V's are never
  // read: P V is only D wide); no copy writes them.
  if constexpr (CH > CD) {
    for (int i = tid; i < (CH - CD) * (BQ + STAGES * BK); i += NTHREADS) {
      const int c = CD + i / (BQ + STAGES * BK);
      const int r = i % (BQ + STAGES * BK);
      bf16* line = r < BQ ? Qs + (c * BQ + r) * 8
                          : Ks + ((r - BQ) / BK) * T::KV_ELEMS + (c * BK + (r - BQ) % BK) * 8;
      *reinterpret_cast<uint4*>(line) = make_uint4(0, 0, 0, 0);
    }
  }
  fence_proxy_async();  // the zeros, for wgmma
  __syncthreads();      // and the barriers, for everyone
  if (tid == 0) {
    mbar_arrive_expect_tx(q_full, CD * BQ * 16);
#pragma unroll
    for (int c = 0; c < CD; ++c)
      tma_load_3d(Qs + c * BQ * 8, &pq.map, h * D + 8 * c, q0, b * pq.batched, q_full);
    for (int j = 0; j < PREFETCH && j < nkt; ++j) load_kv(j);
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of the warp
  float l_run[2] = {0.0f, 0.0f};            // this thread's partial row sums
  float l_lse[2] = {0.0f, 0.0f};            // under a flag: the fp32 sums for lse
  const bool flag_lse = FLAGS != 0 && lse != nullptr;
  // Without a bias or a flag the maximum is taken of the raw products and
  // p is one FFMA away: 2^(s * sc - m). Otherwise s is first mapped to the
  // log2 domain in place, and the multiplier is 1.
  const float mul = (BIAS || FLAGS != 0) ? 1.0f : sc_log2;

  const uint64_t q_desc = smem_desc(Qs + wg * WG_ROWS * 8, BQ * 16, 128);
  uint32_t qa[DP / 16][4];  // Q A fragments, when Q_REGS
  mbar_wait(q_full, 0);
  if constexpr (T::Q_REGS) load_q_frags<DP, BQ>(qa, Qs, wg * WG_ROWS + warp * 16 + g, t);
  float s[NS];
  float corr[2];
  uint32_t pa[BK / 16][4];

  // Tile j's Q K^T is issued together with tile j-1's P V, and tile j's
  // softmax runs while that P V is on the tensor cores; O takes tile j's
  // rescale once P V is done, and the warp then releases tile j-1's stage.
  // Tiles j+1..j+PREFETCH are in flight meanwhile.
  for (int kt = 0; kt < nkt; ++kt) {
    if (tid == 0 && kt + PREFETCH < nkt) load_kv(kt + PREFETCH);
    mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
    __syncwarp();  // wgmma wants the warp converged

    if (kt > 0) pack_p(pa, s);
    fence_regs(acc);
    wgmma_fence();
    issue_scores<DP, BQ, T::Q_REGS>(s, q_desc, qa, Ks + (kt % STAGES) * T::KV_ELEMS);
    wgmma_commit();
    if (kt > 0) {
      issue_pv<D>(acc, pa, Vs + ((kt - 1) % STAGES) * T::KV_ELEMS);
      wgmma_commit();
    }
    if (kt > 0) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    const bool moved =
        kt * BK + BK <= Lk
            ? softmax_tile<FLAGS, BIAS, false>(s, bp, kt * BK, Lk, t, mul, sc_log2, flag_lse,
                                               m_run, l_run, l_lse, corr)
            : softmax_tile<FLAGS, BIAS, true>(s, bp, kt * BK, Lk, t, mul, sc_log2, flag_lse,
                                              m_run, l_run, l_lse, corr);
    if (kt > 0) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
      if (moved) rescale_rows(acc, corr);
    }
  }
  if (nkt > 0) {  // the last tile's P V
    pack_p(pa, s);
    fence_regs(acc);
    wgmma_fence();
    issue_pv<D>(acc, pa, Vs + ((nkt - 1) % STAGES) * T::KV_ELEMS);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  const int row0 = q0 + wg * WG_ROWS + warp * 16 + g;
  bf16* op = o + b * so_b + (long long)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / l;
    if (lse != nullptr) {
      float ls = flag_lse ? l_lse[r] : l;
      if (flag_lse) {
        ls += __shfl_xor_sync(0xffffffffu, ls, 1);
        ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      }
      if (t == 0 && row < Lq)
        lse[((long long)b * gridDim.y + h) * Lq + row] = m_run[r] + log2f(ls);
    }
    if (row < Lq) {
#pragma unroll
      for (int i = 0; i < NO / 4; ++i)
        *reinterpret_cast<uint32_t*>(op + row * so_l + 8 * i + 2 * t) =
            pack_bf16x2(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
    }
  }
}

template <int D, int FLAGS, bool BIAS>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o,
           void* lse, int B, int H, int Lq, int Lk, const long long* st, float sc_log2,
           cudaStream_t stream) {
  using T = Cfg<D, FLAGS, BIAS>;
  constexpr size_t smem = T::SMEM;
  static const cudaError_t attr_err =
      allow_smem(flash_fwd_packed_kernel<D, FLAGS, BIAS>, smem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  Panel p[3];  // q, k, v
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    p[i].batched = st[2 * i] != 0;
    if (make_panel_map(&p[i].map, bases[i], H * D, i == 0 ? Lq : Lk, B, st[2 * i + 1],
                       st[2 * i], i == 0 ? T::BQ : BK) != 0)
      return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((Lq + T::BQ - 1) / T::BQ, H, B);
  flash_fwd_packed_kernel<D, FLAGS, BIAS><<<grid, T::NTHREADS, smem, stream>>>(
      p[0], p[1], p[2], static_cast<const float*>(bias), static_cast<bf16*>(o),
      static_cast<float*>(lse), Lq, Lk, st[6], st[7], sc_log2);
  return (int)cudaGetLastError();
}

template <int D, int FLAGS>
int launch_bias(const void* q, const void* k, const void* v, const void* bias, void* o,
                void* lse, int B, int H, int Lq, int Lk, const long long* st,
                float sc_log2, cudaStream_t s) {
  return bias != nullptr
             ? launch<D, FLAGS, true>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, sc_log2, s)
             : launch<D, FLAGS, false>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, sc_log2, s);
}

template <int D>
int launch_flags(int flags, const void* q, const void* k, const void* v,
                 const void* bias, void* o, void* lse, int B, int H, int Lq, int Lk,
                 const long long* st, float sc_log2, cudaStream_t s) {
  switch (flags) {
    case 0:
      return launch_bias<D, 0>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, sc_log2, s);
    case FLAG_EXP_BF16:
      return launch_bias<D, FLAG_EXP_BF16>(q, k, v, bias, o, lse, B, H, Lq, Lk, st,
                                           sc_log2, s);
    case FLAG_MXU_SUM:
      return launch_bias<D, FLAG_MXU_SUM>(q, k, v, bias, o, lse, B, H, Lq, Lk, st,
                                          sc_log2, s);
    case FLAG_EXP_BF16 | FLAG_MXU_SUM:
      return launch_bias<D, FLAG_EXP_BF16 | FLAG_MXU_SUM>(q, k, v, bias, o, lse, B, H, Lq,
                                                          Lk, st, sc_log2, s);
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

namespace {

template <int D, int FLAGS>
int fwd_rows(bool bias) {
  return bias ? Cfg<D, FLAGS, true>::BQ : Cfg<D, FLAGS, false>::BQ;
}

template <int D>
int fwd_rows_flags(int flags, bool bias) {
  switch (flags) {
    case 0:
      return fwd_rows<D, 0>(bias);
    case FLAG_EXP_BF16:
      return fwd_rows<D, FLAG_EXP_BF16>(bias);
    case FLAG_MXU_SUM:
      return fwd_rows<D, FLAG_MXU_SUM>(bias);
    case FLAG_EXP_BF16 | FLAG_MXU_SUM:
      return fwd_rows<D, FLAG_EXP_BF16 | FLAG_MXU_SUM>(bias);
    default:
      return -1;
  }
}

}  // namespace

// The query rows of one CTA of `flash_attn_packed_fwd` at head dim D, `flags`
// and a key bias (bias != 0) or none: its grid is (ceil(Lq / rows), H, B).
// -1 for a D or flags it is not built for.
extern "C" int flash_attn_packed_fwd_rows(int D, int flags, int bias) {
  switch (D) {
    case 40:
      return fwd_rows_flags<40>(flags, bias != 0);
    case 80:
      return fwd_rows_flags<80>(flags, bias != 0);
    case 160:
      return fwd_rows_flags<160>(flags, bias != 0);
    default:
      return -1;
  }
}
