"""Flash attention, counterpart of `adaface_tpu/ops/flash_attention.py`:
the packed entry `flash_attention_blc` / `flash_attention_qkv` on
`[B, L, H*D]` tensors (the UNet's) and the `[B, H, L, D]` entry
`flash_attention`, with every knob arm of the JAX dispatch, read at call
time (`knobs.py`).

Packed entry, `forward_arm(lq, lk)` (JAX `flash_attention_blc` and
`_flash_forward_blc`'s kernel selection):

- "einsum": Lq < 256, or Lk < 256 unless `ADAFACE_FLASH_CROSS=1` (the
  77-key cross-attention, the 8x8 mid block): `reference_attention`, fp32
  scores, natural-log softmax, additive bias, no floor; autograd
  differentiates it.
- `ADAFACE_FLASH_CROSS=1` with Lk < 256: k and v are padded with zero rows to
  a multiple of 128 and the key bias (zeros when none was given, so the -100
  floor then applies to every score) with -1e30 over the pad, as JAX does;
  the gradients are sliced back.
- the TPU kernel JAX would take, all one function: "K4"
  (`_flash_kernel_heads_short`, Lk <= 256 unless `MAXFREE=0` or `SHORT=0`),
  "K2" (`_pvt2`, `PVT2=1`, or Lq <= 256 when `PVT2` is unset), "K1" (`_pvt`)
  or "K5" (`_flash_kernel_heads`, `MAXFREE=0` or `PVT=0`). On a bf16 CUDA
  tensor every one is the hand-written Hopper kernel
  `csrc/flash_attn_packed.cu`, on an fp32 CUDA tensor (an fp32 pipeline) the
  hand-written fp32 kernel `csrc/flash_attn_fp32.cu` (FFMA, no tensor core);
  on a CPU tensor its plain version `flash_attention_blc_plain`. Under K1
  only, `ADAFACE_FLASH_EXP_BF16=1` (scores rounded to bf16 before exp2, p kept
  in bf16) and `ADAFACE_FLASH_MXU_SUM=1` (the denominator sums bf16(p))
  change the function, in the kernel and in the plain version alike.

`[B, H, L, D]` entry, `bhld_arm(lq, lk)`: "einsum" below 256; "K7"
(`_flash_row_kernel`) under `ADAFACE_FLASH_MODE=row` when Lk <= 4096 and
Lq % min(256, Lq) == 0, else "K6" (`_flash_kernel`). Both fold into a
one-head `[B*H, L, D]` call of the same kernel (a view of a contiguous
tensor), the bias repeated per head. `ADAFACE_FLASH_HOST_PAD=1` (JAX's
zero-padding of D to a multiple of 128, a TPU lane layout in HBM) computes
the same function, so the port reads it and runs the unpadded kernel.

Gradients: `FlashAttentionBLC`, a `torch.autograd.Function` taken only when
autograd records: the forward also writes the row log2-sum-exp (K3a, the
default function's under K1's flags too), the backward is
`csrc/flash_attn_bwd.cu` (K3b dq, K3c dk/dv/dbias, whose query loop
`bwd_launch_plan` splits where its key blocks leave SMs idle) in bf16,
`csrc/flash_attn_fp32.cu`'s dq and dk/dv/dbias in fp32 (plain
`flash_backward_plain` on the CPU), dbias summed over heads. Under
`ADAFACE_FLASH_BWD=einsum` the backward differentiates `reference_attention`
instead, bias included, as XLA does for that arm.

`launches_by_shape` counts kernel launches per (kind, arm, B, Lq, Lk, H, D):
kind "fwd" (arm the TPU kernel id, with "+exp_bf16" / "+mxu_sum" under K1's
flags, or "direct" for a call of the wrapper itself), "dq" (arm "K3b") or
"dkv" ("K3c"); a fold counts B*H rows of one head. Launches of the fp32
kernels count under "fwd_fp32", "dq_fp32" and "dkv_fp32". Callers may clear
it to count one run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from adaface_tpu_torch import kernels, knobs
from adaface_tpu_torch.device import sm_count

LOG2E = 1.4426950408889634
# Floor on biased log2-domain scores (the TPU kernels' _SCORE_FLOOR): a fully
# masked key row (bias -1e30 everywhere) comes out uniform instead of 0/0.
SCORE_FLOOR = -100.0
MIN_KERNEL_LEN = 256
KERNEL_HEAD_DIMS = (40, 80, 160)  # the UNet's head dims
# bf16 runs csrc/flash_attn_packed.cu and flash_attn_bwd.cu; fp32 (an fp32
# pipeline) csrc/flash_attn_fp32.cu
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
FLAG_EXP_BF16, FLAG_MXU_SUM = 1, 2
# the row kernel K7 takes Lk up to this, with query blocks of this many rows
ROW_MAX_LK, ROW_BLOCK_Q = 4096, 256

# The backward kernels' tiling (csrc/flash_attn_bwd.cu: Cfg): a dk/dv CTA
# owns 64 keys per warpgroup (bwd_cta_rows) over streamed tiles of 64 query
# rows, and may split its query loop over up to BWD_MAX_SPLIT CTAs.
BWD_TILE = 64
BWD_MAX_SPLIT = 8
# What the split choice weighs (H100 SXM data sheet): a CTA's query tile at
# a third of the tensor cores' peak per SM (what the kernel reaches), the
# fp32 partials written and read again at the memory's peak, and the partial
# sums' second launch.
_TILE_FLOPS_PER_SM = 989e12 / 132 / 3
_PEAK_BYTES = 3.35e12
_SUM_LAUNCH_S = 4e-6

launches_by_shape: Dict[Tuple[str, str, int, int, int, int, int], int] = {}



# ------------------------------------------------------------------ dispatch
def cross_pad_len(lk: int) -> int:
    """Lk padded to a multiple of 128, the CROSS arm's key panel."""
    return (lk + 127) // 128 * 128


def forward_arm(lq: int, lk: int) -> str:
    """The TPU kernel the JAX packed entry takes for these lengths under the
    current knobs ("K1", "K2", "K4" or "K5"), or "einsum". `lk` is the
    caller's, before the CROSS pad."""
    short_lk = lk < MIN_KERNEL_LEN
    if lq < MIN_KERNEL_LEN or (short_lk and knobs.get("ADAFACE_FLASH_CROSS") != "1"):
        return "einsum"
    if short_lk:
        lk = cross_pad_len(lk)
    maxfree = knobs.get("ADAFACE_FLASH_MAXFREE") != "0"
    use_pvt = maxfree and knobs.get("ADAFACE_FLASH_PVT") != "0"
    pvt2_env = knobs.get("ADAFACE_FLASH_PVT2")
    pvt2 = (lq <= 256) if pvt2_env is None else pvt2_env == "1"
    if maxfree and lk <= 256 and knobs.get("ADAFACE_FLASH_SHORT") != "0":
        return "K4"
    if use_pvt:
        return "K2" if pvt2 else "K1"
    return "K5"


def k1_flags() -> int:
    """K1's arithmetic arms as a mask: FLAG_EXP_BF16 under
    `ADAFACE_FLASH_EXP_BF16=1`, FLAG_MXU_SUM under `ADAFACE_FLASH_MXU_SUM=1`."""
    return ((FLAG_EXP_BF16 if knobs.get("ADAFACE_FLASH_EXP_BF16") == "1" else 0)
            | (FLAG_MXU_SUM if knobs.get("ADAFACE_FLASH_MXU_SUM") == "1" else 0))


def arm_id(arm: str, flags: int = 0) -> str:
    """The launch counter's arm label: the TPU kernel id, plus K1's flags."""
    return (arm + ("+exp_bf16" if flags & FLAG_EXP_BF16 else "")
            + ("+mxu_sum" if flags & FLAG_MXU_SUM else ""))


def bhld_arm(lq: int, lk: int) -> str:
    """The TPU kernel the JAX `[B, H, L, D]` entry takes ("K6" or "K7"), or
    "einsum"."""
    if lq < MIN_KERNEL_LEN or lk < MIN_KERNEL_LEN:
        return "einsum"
    use_row = (knobs.get("ADAFACE_FLASH_MODE", "online") == "row" and lk <= ROW_MAX_LK
               and lq % min(ROW_BLOCK_Q, lq) == 0)
    return "K7" if use_row else "K6"


def _use_einsum_bwd() -> bool:
    return knobs.get("ADAFACE_FLASH_BWD") == "einsum"


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, w = t.shape
    return t.reshape(b, l, heads, w // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, d = t.shape
    return t.transpose(1, 2).reshape(b, l, h * d)


def reference_attention_bhld(q, k, v, key_bias=None, scale=None):
    """The JAX package's `_reference_attention` on [B, H, L, D]: scores from
    an fp32 product of the inputs (JAX's `preferred_element_type=float32`),
    plus the additive bias, fp32 softmax, probabilities cast to v's dtype for
    the value product."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def reference_attention(q, k, v, num_heads: int, key_bias=None, scale=None):
    """`reference_attention_bhld` on packed [B, L, H*D] tensors."""
    d = q.shape[-1] // num_heads
    out = reference_attention_bhld(*(_split_heads(t, num_heads) for t in (q, k, v)),
                                   key_bias, d ** -0.5 if scale is None else scale)
    return _merge_heads(out)


# ------------------------------------------------------------- plain versions
def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def _heads(t: torch.Tensor, i: int, num_heads: int, dtype) -> torch.Tensor:
    """Batch row i of a packed tensor as [H, L, D] in `dtype`."""
    l, inner = t.shape[1], t.shape[2]
    return t[i].to(dtype).reshape(l, num_heads, inner // num_heads).transpose(0, 1)


def _log2_scores(qh, kh, bias_row, scale):
    """The kernels' log2-domain scores of one batch row, [H, Lq, Lk]:
    (q.k) * scale * log2e, plus bias * log2e floored at -100 when a bias is
    given."""
    s = torch.matmul(qh, kh.transpose(1, 2)) * (scale * LOG2E)
    if bias_row is not None:
        s = torch.clamp_min(s + bias_row.to(s.dtype) * LOG2E, SCORE_FLOOR)
    return s


def flash_attention_blc_plain(q, k, v, num_heads: int, key_bias=None,
                              scale=None, flags: int = 0) -> torch.Tensor:
    """The forward kernel's function in plain torch ops (fp32, or fp64 for
    fp64 inputs): the log2-domain scores of `_log2_scores`, then a base-2
    softmax over the keys. One batch row at a time, which bounds the
    [H, Lq, Lk] score slab. Returns [B, Lq, H*D] in the compute dtype.

    With K1's `flags` it follows the TPU kernel's max-free formula
    literally: p = 2^s (2^bf16(s) rounded to bf16 under FLAG_EXP_BF16), the
    value product takes p cast to q's dtype, and the denominator sums p in
    fp32, or that cast p under FLAG_MXU_SUM."""
    b, lq, inner = q.shape
    scale = (inner // num_heads) ** -0.5 if scale is None else scale
    cdt = _compute_dtype(q)
    out = torch.empty((b, lq, inner), dtype=cdt, device=q.device)
    for i in range(b):
        s = _log2_scores(_heads(q, i, num_heads, cdt), _heads(k, i, num_heads, cdt),
                         None if key_bias is None else key_bias[i], scale)
        vh = _heads(v, i, num_heads, cdt)
        if flags:
            p = torch.exp2(s.to(torch.bfloat16)) if flags & FLAG_EXP_BF16 else torch.exp2(s)
            pv = p.to(q.dtype).to(cdt)
            l = (pv if flags & FLAG_MXU_SUM else p.to(cdt)).sum(dim=-1, keepdim=True)
            o = torch.matmul(pv, vh) / l
        else:
            p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
            o = torch.matmul(p, vh) / p.sum(dim=-1, keepdim=True)
        out[i] = o.transpose(0, 1).reshape(lq, inner)
    return out


def row_lse_plain(q, k, num_heads: int, key_bias=None, scale=None) -> torch.Tensor:
    """Row log2-sum-exp of the forward's log2-domain scores, [B, H, Lq]
    (`_row_lse_kernel`): lse2 = m + log2(sum 2^(s - m))."""
    b, lq, inner = q.shape
    scale = (inner // num_heads) ** -0.5 if scale is None else scale
    cdt = _compute_dtype(q)
    out = torch.empty((b, num_heads, lq), dtype=cdt, device=q.device)
    for i in range(b):
        s = _log2_scores(_heads(q, i, num_heads, cdt), _heads(k, i, num_heads, cdt),
                         None if key_bias is None else key_bias[i], scale)
        m = s.amax(dim=-1)
        out[i] = m + torch.log2(torch.exp2(s - m[..., None]).sum(dim=-1))
    return out


def flash_backward_plain(q, k, v, key_bias, o, do, lse, num_heads: int, scale=None):
    """`_flash_backward` in plain torch ops (fp32, or fp64 for fp64 inputs)
    on packed tensors: p = 2^(s - lse), dp = dO V^T, delta = rowsum(dO o),
    ds = p (dp - delta), dq = ds K scale, dk = ds^T Q scale, dv = p^T dO,
    dbias_h = sum_q ds. ds is the gradient of the natural-log scores and is
    not zeroed where the floor clamped a score. Returns (dq, dk, dv) packed
    [B, L, H*D] and dbias_h [B, H, Lk]."""
    b, lq, inner = q.shape
    lk = k.shape[1]
    scale = (inner // num_heads) ** -0.5 if scale is None else scale
    cdt = _compute_dtype(q)
    dq = torch.empty((b, lq, inner), dtype=cdt, device=q.device)
    dk = torch.empty((b, lk, inner), dtype=cdt, device=q.device)
    dv = torch.empty_like(dk)
    dbias = torch.empty((b, num_heads, lk), dtype=cdt, device=q.device)
    for i in range(b):
        qh, kh, vh, oh, doh = (_heads(t, i, num_heads, cdt) for t in (q, k, v, o, do))
        s = _log2_scores(qh, kh, None if key_bias is None else key_bias[i], scale)
        p = torch.exp2(s - lse[i].to(cdt)[..., None])
        dp = torch.matmul(doh, vh.transpose(1, 2))
        delta = (doh * oh).sum(dim=-1)
        ds = p * (dp - delta[..., None])
        dq[i] = (torch.matmul(ds, kh) * scale).transpose(0, 1).reshape(lq, inner)
        dk[i] = (torch.matmul(ds.transpose(1, 2), qh) * scale).transpose(0, 1).reshape(lk, inner)
        dv[i] = torch.matmul(p.transpose(1, 2), doh).transpose(0, 1).reshape(lk, inner)
        dbias[i] = ds.sum(dim=1)
    return dq, dk, dv, dbias


def tile_slices(n: int, split: int) -> List[Tuple[int, int]]:
    """The rows [r0, r1) of each slice of a split of `n` streamed rows, as
    the split backward kernels take them: slice s has tiles [s T / split,
    (s + 1) T / split) of the T tiles of BWD_TILE rows."""
    tiles = -(-n // BWD_TILE)
    return [(s * tiles // split * BWD_TILE, min((s + 1) * tiles // split * BWD_TILE, n))
            for s in range(split)]


def dkv_slices_plain(q, k, v, key_bias, o, do, lse, num_heads: int, scale=None,
                     split: int = 1):
    """`flash_backward_plain`'s (dk, dv, dbias_h) of each query slice of a
    dk/dv launch split `split` ways (`tile_slices`), in slice order: summed
    in that order they are the split kernel's fp32 result."""
    parts = []
    for r0, r1 in tile_slices(q.shape[1], split):
        rows = slice(r0, r1)
        parts.append(flash_backward_plain(q[:, rows], k, v, key_bias, o[:, rows], do[:, rows],
                                          lse[:, :, rows], num_heads, scale)[1:])
    return parts


# ------------------------------------------------------------ backward plan
def bwd_cta_rows(d: int) -> int:
    """Keys a dk/dv CTA owns at head dim d: two warpgroups of 64, or at d160
    one pair of column halves (Cfg::DKV_ROWS)."""
    return BWD_TILE if d > 80 else 2 * BWD_TILE


class BwdPlan(NamedTuple):
    """The dk/dv grid of one backward call: `key_ctas` CTAs of
    `bwd_cta_rows(d)` keys (key blocks x heads x batch rows), each key
    block's query loop split over `split` CTAs."""
    key_ctas: int
    split: int


@functools.lru_cache(maxsize=256)
def bwd_launch_plan(b: int, h: int, lq: int, lk: int, d: int, sms: int) -> BwdPlan:
    """The backward's launch plan on a card of `sms` SMs. dk/dv runs one CTA
    per (key block, head, batch row) at one CTA an SM; where those leave SMs
    idle (the cross-attention's 128 keys, L256) the query loop is split: the
    split minimises waves x query tiles per CTA x a tile's time, plus the
    partials' extra bytes and their sum's launch."""
    rows = bwd_cta_rows(d)
    ctas = -(-lk // rows) * h * b
    nqt = -(-lq // BWD_TILE)
    work = 1.5 if d > 80 else 1.0  # d160: both column halves compute S^T and dP^T
    t_tile = work * 8 * BWD_TILE * rows * d / _TILE_FLOPS_PER_SM

    def cost(split):
        waves = -(-ctas * split // sms)
        extra = (0.0 if split == 1 else
                 2 * 4 * split * b * h * lk * (2 * d + 1) / _PEAK_BYTES + _SUM_LAUNCH_S)
        return waves * -(-nqt // split) * t_tile + extra

    split = min(range(1, min(nqt, BWD_MAX_SPLIT) + 1), key=cost)
    return BwdPlan(ctas, split)


def dkv_work(b: int, h: int, lq: int, lk: int, d: int,
             split: int) -> List[Tuple[int, int, int, int, int]]:
    """(batch row, head, first key, first query tile, end query tile) of
    each dk/dv CTA, in the order of its grid (`flash_bwd_dkv_kernel`: x =
    key block * split + slice, y = head, z = batch row); slice s of a key
    block covers query tiles [s * T / split, (s + 1) * T / split) of the T
    tiles of 64."""
    nqt, rows = -(-lq // BWD_TILE), bwd_cta_rows(d)
    return [(bi, hi, kb * rows, s * nqt // split, (s + 1) * nqt // split)
            for bi in range(b) for hi in range(h)
            for kb in range(-(-lk // rows)) for s in range(split)]


# ---------------------------------------------------- fp32 forward plan
# The fp32 forward's tiling (csrc/flash_attn_fp32.cu: FwdCfg): a row group
# of FWD_FP32_WARP_ROWS[d] query rows is taken by one warp, or by two that
# split each key tile (the key split); a CTA has 1, 2 or 4 warps. Keys
# stream in tiles of 64 through a ring of FWD_FP32_STAGES stages of 40 head
# columns (80 at d160 under the key split).
FWD_FP32_WARP_ROWS = {40: 32, 80: 32, 160: 16}
FWD_FP32_WARPS = (4, 2, 1)
FWD_FP32_STAGES = 3
_FWD_FP32_LDP = 72  # floats between rows of a warp's p tile
# Fewer row groups than this many an SM leave SMs with few warps to hide
# latency (the B3 / B4 L256 d160 grids): their keys are split.
_FWD_FP32_SPLIT_BELOW = 4
# What a CTA costs beyond its rows, in rows: its share of the K/V copies
# and its start (a guess that flash_variants.py's forced plans measure)
_FWD_FP32_CTA_ROWS = 16


class Fp32FwdPlan(NamedTuple):
    """One fp32 forward launch: `rows` query rows a CTA, `threads` threads
    a CTA (each row group of FWD_FP32_WARP_ROWS[d] rows taken by
    `key_split` warps), `ctas` CTAs (query blocks x heads x batch rows),
    `smem` bytes of shared memory a CTA."""
    rows: int
    threads: int
    key_split: int
    ctas: int
    smem: int


def fwd_fp32_smem(d: int, rows: int, warps: int, key_split: int = 1) -> int:
    """Shared memory of an fp32 forward CTA of `rows` rows and `warps` warps
    at head dim d: its Q tile, the ring (a stage: one chunk of K or V for 64
    keys, then the tile's bias) and the warps' p tiles (FwdCfg::smem)."""
    cw = 80 if d == 160 and key_split == 2 else 40
    return 4 * (rows * (d + 4) + FWD_FP32_STAGES * (64 * (cw + 4) + 64)
                + warps * FWD_FP32_WARP_ROWS[d] * _FWD_FP32_LDP)


@functools.lru_cache(maxsize=256)
def fwd_fp32_launch_plan(b: int, h: int, lq: int, lk: int, d: int, sms: int,
                         key_split: Optional[int] = None) -> Fp32FwdPlan:
    """The fp32 forward's launch plan on a card of `sms` SMs. The key split
    is 2 where the row groups number fewer than _FWD_FP32_SPLIT_BELOW a SM
    (or `key_split` when given). Of the CTAs of 1, 2 or 4 warps, those whose
    grid puts a CTA on every SM if any do; of those, the one with the fewest
    rows (plus a CTA's cost) on the busiest SM, the larger CTA on a tie
    (fewer K/V bytes a row). Raises ValueError for a head dim the kernel is
    not built for."""
    if d not in FWD_FP32_WARP_ROWS:
        raise ValueError(f"the fp32 forward is built for head dims "
                         f"{tuple(FWD_FP32_WARP_ROWS)}, not {d}")
    wr = FWD_FP32_WARP_ROWS[d]
    if key_split is None:
        key_split = 2 if -(-lq // wr) * h * b < _FWD_FP32_SPLIT_BELOW * sms else 1
    plans = []
    for w in FWD_FP32_WARPS:
        if w % key_split == 0:
            rows = w // key_split * wr
            plans.append(Fp32FwdPlan(rows, 32 * w, key_split, -(-lq // rows) * h * b,
                                     fwd_fp32_smem(d, rows, w, key_split)))
    filled = [p for p in plans if p.ctas >= sms] or plans
    return min(filled, key=lambda p: (-(-p.ctas // sms) * (p.rows + _FWD_FP32_CTA_ROWS),
                                      -p.rows))


def fwd_fp32_blocks(b: int, h: int, lq: int, rows: int) -> List[Tuple[int, int, int, int]]:
    """(batch row, head, first query row, end query row) of each fp32
    forward CTA, in the order of its grid (x = query block, y = head, z =
    batch row); the last block of a head stops at Lq."""
    return [(bi, hi, r0, min(r0 + rows, lq)) for bi in range(b) for hi in range(h)
            for r0 in range(0, lq, rows)]


# --------------------------------------------------- fp32 backward plan
# The fp32 backward's tiling (csrc/flash_attn_fp32.cu: BwdCfg): a CTA of 1, 2
# or 4 warps holds BWD_FP32_WARP_ROWS[kind][d] resident rows a warp (query
# rows of Q and dO for "dq", keys of K and V for "dkv") and streams the other
# side in tiles of 64 rows through a ring of BWD_FP32_STAGES stages of 40
# head columns, over all the tiles or over a slice of them (a split of up
# to BWD_FP32_MAX_SPLIT slices, whose partials a second launch sums in slice
# order).
BWD_FP32_WARP_ROWS = {"dq": {40: 32, 80: 16, 160: 16}, "dkv": {40: 32, 80: 16, 160: 8}}
BWD_FP32_WARPS = (4, 2, 1)
BWD_FP32_STAGES = 2
BWD_FP32_MAX_SPLIT = 4
# What the plan weighs (H100 SXM): an SM's shared memory (each CTA reserves
# 1 KiB more) and the warps its registers hold at 255 a thread; an SM with
# all of them reaching half its FFMA peak (the fp32 forward: 54-56%), fewer
# warps proportionally less; a CTA's start (its resident tiles, the ring's
# fill) as this many streamed tiles (a guess that flash_variants.py's forced
# plans measure); a split's partials written and read at the memory's peak
# and the sum's launch.
_SM_SMEM = 228 * 1024
_SM_WARPS = 8
_BWD_FP32_SM_FLOPS = 67e12 / 132 * 0.5
_BWD_FP32_START_TILES = 1.0


class Fp32BwdLaunch(NamedTuple):
    """One fp32 backward launch: `rows` resident rows a CTA (query rows for
    dq, keys for dk/dv), `threads` threads a CTA, `split` slices of the
    streamed tiles, `ctas` CTAs (blocks x slices x heads x batch rows),
    `smem` bytes of shared memory a CTA."""
    rows: int
    threads: int
    split: int
    ctas: int
    smem: int


class Fp32BwdPlan(NamedTuple):
    """The launches of one fp32 backward call: dq's and dk/dv's."""
    dq: Fp32BwdLaunch
    dkv: Fp32BwdLaunch


def bwd_fp32_smem(kind: str, d: int, warps: int) -> int:
    """Shared memory of an fp32 backward CTA of `warps` warps at head dim d
    (BwdCfg::smem): its two resident tiles, the ring (a stage: one 40-column
    chunk of 64 streamed rows, then the tile's 64 values of bias, lse or
    delta), the warps' p / ds tiles and, for dq, its rows' lse and delta."""
    wr = BWD_FP32_WARP_ROWS[kind][d] * warps
    return 4 * (2 * wr * (d + 4) + BWD_FP32_STAGES * (64 * 44 + 64) + wr * _FWD_FP32_LDP
                + (2 * wr if kind == "dq" else 0))


def _bwd_fp32_seconds(kind, b, h, n_res, n_str, d, sms, warps, split):
    """The plan's estimate of one launch's time: the busiest SM runs its
    CTAs in rounds of as many as it holds at once, each at the share of the
    SM's rate that its warps reach; plus a split's partials and sum."""
    rows = warps * BWD_FP32_WARP_ROWS[kind][d]
    tasks = -(-n_res // rows) * h * b * split
    resident = min(_SM_WARPS // warps,
                   _SM_SMEM // (bwd_fp32_smem(kind, d, warps) + 1024))
    n_tiles = -(-n_str // BWD_TILE)
    longest = -(-n_tiles // split)  # tiles of the longest slice
    work = rows * (longest + _BWD_FP32_START_TILES) * BWD_TILE * d * (6 if kind == "dq" else 8)
    full, rem = divmod(-(-tasks // sms), resident)
    t = sum(n * work / (_BWD_FP32_SM_FLOPS * min(n * warps, _SM_WARPS) / _SM_WARPS)
            for n in [resident] * full + ([rem] if rem else []))
    if split > 1:
        outs = b * h * n_res * (d if kind == "dq" else 2 * d + 1)
        t += 2 * 4 * split * outs / _PEAK_BYTES + _SUM_LAUNCH_S
    return t


def _bwd_fp32_launch(kind, b, h, n_res, n_str, d, sms) -> Fp32BwdLaunch:
    tiles = -(-n_str // BWD_TILE)
    plans = []
    for w in BWD_FP32_WARPS:
        for s in range(1, min(BWD_FP32_MAX_SPLIT, tiles) + 1):
            rows = w * BWD_FP32_WARP_ROWS[kind][d]
            launch = Fp32BwdLaunch(rows, 32 * w, s, -(-n_res // rows) * h * b * s,
                                   bwd_fp32_smem(kind, d, w))
            plans.append((_bwd_fp32_seconds(kind, b, h, n_res, n_str, d, sms, w, s), -rows,
                          s, launch))
    filled = [p for p in plans if p[3].ctas >= sms] or plans
    return min(filled)[3]


@functools.lru_cache(maxsize=256)
def bwd_fp32_launch_plan(b: int, h: int, lq: int, lk: int, d: int, sms: int) -> Fp32BwdPlan:
    """The fp32 backward's launch plan on a card of `sms` SMs: for dq (query
    blocks, the key tiles split) and for dk/dv (key blocks, the query tiles
    split), of the CTAs of 1, 2 or 4 warps and the splits of 1 to
    BWD_FP32_MAX_SPLIT, those whose grid
    puts a CTA on every SM if any do; of those, the one that
    `_bwd_fp32_seconds` puts first, the larger CTA, then the smaller split,
    on a tie. Raises ValueError for a head dim the kernels are not built
    for."""
    if d not in BWD_FP32_WARP_ROWS["dq"]:
        raise ValueError(f"the fp32 backward is built for head dims "
                         f"{tuple(BWD_FP32_WARP_ROWS['dq'])}, not {d}")
    return Fp32BwdPlan(_bwd_fp32_launch("dq", b, h, lq, lk, d, sms),
                       _bwd_fp32_launch("dkv", b, h, lk, lq, d, sms))


# ------------------------------------------------------------- CUDA wrappers
def _check_operand(t: torch.Tensor, name: str, device, b: int, inner: int,
                   dtype: torch.dtype = torch.bfloat16):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"the CUDA kernels take {dtype} here (q's dtype), {name} is {t.dtype}")
    if t.dim() != 3 or t.shape[0] != b or t.shape[2] != inner:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want [{b}, L, {inner}]")
    if t.stride(2) != 1 or (dtype == torch.bfloat16 and (
            t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16)):
        raise ValueError(f"{name} needs unit column stride and, in bf16, batch and row "
                         f"strides that are multiples of 8 and a 16-byte aligned start; "
                         f"got strides {t.stride()} at {t.data_ptr():#x}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> (library, argument types), as declared in csrc/<library>.cu
C_ENTRIES = {
    "flash_attn_packed_fwd": ("flash_attn_packed", [_P] * 6 + [_I] * 6 + [_P, _F, _P]),
    "flash_attn_packed_fwd_rows": ("flash_attn_packed", [_I] * 3),
    "flash_attn_bwd_dq": ("flash_attn_bwd", [_P] * 8 + [_I] * 5 + [_P, _F, _F, _P]),
    "flash_attn_bwd_dkv": ("flash_attn_bwd", [_P] * 10 + [_I] * 5 + [_P, _F, _F, _I, _P, _P]),
    "flash_attn_bwd_rows": ("flash_attn_bwd", [_I] * 2),
    "flash_attn_fp32_fwd": ("flash_attn_fp32", [_P] * 6 + [_I] * 8 + [_P, _F, _P]),
    "flash_attn_fp32_bwd_dq": ("flash_attn_fp32", [_P] * 8 + [_I] * 8 + [_P, _F, _F, _P, _P]),
    "flash_attn_fp32_bwd_dkv": ("flash_attn_fp32",
                                [_P] * 10 + [_I] * 8 + [_P, _F, _F, _P, _P]),
}


def _fn(name: str):
    """The ctypes entry `name` of its library, with its signature set."""
    return kernels.entry(name, *C_ENTRIES[name])


def cta_rows(kind: str, d: int, flags: int = 0, bias: bool = False) -> int:
    """The rows one CTA of a bf16 launch of `kind` owns at head dim d, asked
    of the built kernel: query rows of "fwd" (with K1's `flags` and a key
    bias or none) and "dq", keys of "dkv". The grid is ceil(L / rows) x H x
    B CTAs, times the split for "dkv"."""
    if kind == "fwd":
        rows = _fn("flash_attn_packed_fwd_rows")(d, flags, int(bias))
    else:
        rows = _fn("flash_attn_bwd_rows")(d, int(kind == "dkv"))
    if rows < 1:
        raise ValueError(f"no {kind} kernel is built for d {d}, flags {flags}")
    return rows


def _check_call(q, k, v, num_heads, key_bias):
    """Shared argument checks of the CUDA wrappers; returns (b, lq, lk, d,
    fp32 contiguous bias or None)."""
    b, lq, inner = q.shape
    lk = k.shape[1]
    if inner % num_heads:
        raise ValueError(f"width {inner} is not a multiple of {num_heads} heads")
    d = inner // num_heads
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for head dims "
                         f"{KERNEL_HEAD_DIMS}, not {d}")
    if q.device.type != "cuda":
        raise ValueError(f"q is on {q.device}, not a CUDA device")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernels take bfloat16 or float32, q is {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, name, q.device, b, inner, q.dtype)
    if v.shape[1] != lk:
        raise ValueError(f"k has {lk} keys, v {v.shape[1]}")
    bias = None
    if key_bias is not None:
        if key_bias.device != q.device or tuple(key_bias.shape) != (b, lk):
            raise ValueError(f"key_bias must be [{b}, {lk}] on {q.device}, got "
                             f"{tuple(key_bias.shape)} on {key_bias.device}")
        bias = key_bias.detach().to(torch.float32).contiguous()
    return b, lq, lk, d, bias


def _count(kind: str, arm: str, key: tuple, dtype: torch.dtype = torch.bfloat16):
    """One launch of `kind` at `arm` and `key`; an fp32 launch (the kernels of
    `csrc/flash_attn_fp32.cu`) counts under kind + "_fp32"."""
    k = (kind + ("_fp32" if dtype == torch.float32 else ""), arm) + key
    launches_by_shape[k] = launches_by_shape.get(k, 0) + 1


def _raise_if(err: int, what: str, key: tuple):
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err} (B, Lq, Lk, H, d = {key})")


def flash_attention_blc_cuda(q, k, v, num_heads: int, key_bias=None, scale=None,
                             return_lse: bool = False, arm: str = "direct",
                             flags: int = 0):
    """Launch the forward Hopper kernel on CUDA tensors: bf16 operands go to
    `csrc/flash_attn_packed.cu`, fp32 ones to `csrc/flash_attn_fp32.cu` (with
    the rows and threads a CTA of `fwd_fp32_launch_plan`); raises
    on anything it does not take (dtype, head dim, strides, alignment). `arm`
    labels the launch in `launches_by_shape`; `flags` are K1's arithmetic
    arms. With `return_lse`, returns (out, lse2 [B, H, Lq] fp32)."""
    b, lq, lk, d, bias = _check_call(q, k, v, num_heads, key_bias)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, lq, num_heads * d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, num_heads, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    st = _strides(q, k, v, out)
    key = (b, lq, lk, num_heads, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fp32 = q.dtype == torch.float32
        name = "flash_attn_fp32_fwd" if fp32 else "flash_attn_packed_fwd"
        plan = (fwd_fp32_launch_plan(b, num_heads, lq, lk, d, sm_count(q.device.index))[:2]
                if fp32 else ())
        err = _fn(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, num_heads, lq, lk, d, flags, *plan, ctypes.addressof(st), scale * LOG2E, stream)
    _raise_if(err, name, key)
    _count("fwd", arm_id(arm, flags), key, q.dtype)
    return (out, lse) if return_lse else out


def _pitch4(t: torch.Tensor) -> torch.Tensor:
    """t with its last axis padded to a multiple of 4 values, 16-byte
    aligned: the backward kernels' layout of lse, delta and the bias (their
    1-D TMA copies start on 16-byte boundaries). No copy when the length is
    a multiple of 4 and t is aligned, as on every path of the UNet."""
    pad = -t.shape[-1] % 4
    if pad == 0 and t.data_ptr() % 16 == 0:
        return t
    return F.pad(t, (0, pad))


def _check_backward(q, k, v, key_bias, do, lse, delta, num_heads, scale):
    """Argument checks of the backward wrappers; returns (b, lq, lk, d, bias,
    lse, delta, scale) with the bias, lse and delta in the kernels' layout."""
    b, lq, lk, d, bias = _check_call(q, k, v, num_heads, key_bias)
    _check_operand(do, "dO", q.device, b, num_heads * d, q.dtype)
    for t, name in ((lse, "lse"), (delta, "delta")):
        if (tuple(t.shape) != (b, num_heads, lq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 [{b}, {num_heads}, {lq}] "
                             f"on {q.device}")
    scale = d ** -0.5 if scale is None else scale
    if q.dtype == torch.float32:  # the fp32 kernels read lse, delta and bias by element
        return b, lq, lk, d, bias, lse, delta, scale
    return (b, lq, lk, d, None if bias is None else _pitch4(bias), _pitch4(lse),
            _pitch4(delta), scale)


def row_delta(o: torch.Tensor, do: torch.Tensor, num_heads: int) -> torch.Tensor:
    """delta = rowsum(dO o) per head, fp32 [B, H, Lq], from the saved o (a
    plain op outside the kernels, as in the JAX package)."""
    b, lq, inner = o.shape
    delta = (do.float() * o.float()).view(b, lq, num_heads, inner // num_heads).sum(-1)
    return delta.transpose(1, 2).contiguous()


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in (t.stride(0), t.stride(1))]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_bwd_dq_cuda(q, k, v, key_bias, do, lse, delta, num_heads: int, scale=None):
    """Launch the dq kernel on CUDA tensors (bf16: `csrc/flash_attn_bwd.cu`;
    fp32: `csrc/flash_attn_fp32.cu` with the rows and threads a CTA and the
    key tiles' split of `bwd_fp32_launch_plan`); returns dq packed in q's
    dtype."""
    b, lq, lk, d, bias, lse, delta, scale = _check_backward(q, k, v, key_bias, do, lse, delta,
                                                            num_heads, scale)
    dq = torch.empty((b, lq, num_heads * d), dtype=q.dtype, device=q.device)
    st = _strides(q, k, v, do, dq)
    key = (b, lq, lk, num_heads, d)
    fp32 = q.dtype == torch.float32
    name = "flash_attn_fp32_bwd_dq" if fp32 else "flash_attn_bwd_dq"
    with torch.cuda.device(q.device):
        plan, tail = (), ()
        if fp32:
            launch = bwd_fp32_launch_plan(b, num_heads, lq, lk, d, sm_count(q.device.index)).dq
            ws = (torch.empty(launch.split * dq.numel(), dtype=torch.float32, device=q.device)
                  if launch.split > 1 else None)
            plan, tail = launch[:3], (None if ws is None else ws.data_ptr(),)
        err = _fn(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if bias is None else bias.data_ptr(), dq.data_ptr(),
            b, num_heads, lq, lk, d, *plan, ctypes.addressof(st), scale * LOG2E, scale,
            *tail, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, name, key)
    _count("dq", "K3b", key, q.dtype)
    return dq


def flash_bwd_dkv_cuda(q, k, v, key_bias, do, lse, delta, num_heads: int, scale=None,
                       need_dbias: bool = False, split: Optional[int] = None):
    """Launch the dk/dv kernel on CUDA tensors; returns (dk, dv) packed in
    q's dtype and, with `need_dbias`, the per-head dbias [B, H, Lk] fp32
    (else None). bf16: `csrc/flash_attn_bwd.cu`, whose query loop's split
    comes from `bwd_launch_plan` unless `split` is given (1 .. min(
    BWD_MAX_SPLIT, query tiles)); fp32: `csrc/flash_attn_fp32.cu` with the
    keys and threads a CTA and the query tiles' split of
    `bwd_fp32_launch_plan`."""
    b, lq, lk, d, bias, lse, delta, scale = _check_backward(q, k, v, key_bias, do, lse, delta,
                                                            num_heads, scale)
    if q.dtype == torch.float32:
        if split is not None:
            raise ValueError(f"the fp32 dk/dv kernel takes its plan's split, got {split}")
        return _dkv_fp32(q, k, v, do, lse, delta, bias, b, lq, lk, d, num_heads, scale,
                         need_dbias)
    if split is None:
        split = bwd_launch_plan(b, num_heads, lq, lk, d, sm_count(q.device.index)).split
    if not 1 <= split <= min(BWD_MAX_SPLIT, -(-lq // BWD_TILE)):
        raise ValueError(f"split {split} is outside 1..{BWD_MAX_SPLIT} or the query tiles")
    dk = torch.empty((b, lk, num_heads * d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dbias = (torch.empty((b, num_heads, lk), dtype=torch.float32, device=q.device)
             if need_dbias else None)
    ws = (torch.empty(split * b * num_heads * lk * (2 * d + 1), dtype=torch.float32,
                      device=q.device) if split > 1 else None)
    st = _strides(q, k, v, do, dk, dv)
    key = (b, lq, lk, num_heads, d)
    with torch.cuda.device(q.device):
        err = _fn("flash_attn_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if bias is None else bias.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if dbias is None else dbias.data_ptr(),
            b, num_heads, lq, lk, d, ctypes.addressof(st), scale * LOG2E, scale, split,
            None if ws is None else ws.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, "flash_attn_bwd_dkv", key)
    _count("dkv", "K3c", key)
    return dk, dv, dbias


def _dkv_fp32(q, k, v, do, lse, delta, bias, b, lq, lk, d, num_heads, scale, need_dbias):
    dk = torch.empty((b, lk, num_heads * d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dbias = (torch.empty((b, num_heads, lk), dtype=torch.float32, device=q.device)
             if need_dbias else None)
    st = _strides(q, k, v, do, dk, dv)
    key = (b, lq, lk, num_heads, d)
    with torch.cuda.device(q.device):
        plan = bwd_fp32_launch_plan(b, num_heads, lq, lk, d, sm_count(q.device.index)).dkv
        # each slice: dk, dv, then dbias rounded up to 4 floats (16-byte slices)
        per = 2 * dk.numel() + (0 if dbias is None else -(-dbias.numel() // 4) * 4)
        ws = (torch.empty(plan.split * per, dtype=torch.float32, device=q.device)
              if plan.split > 1 else None)
        err = _fn("flash_attn_fp32_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if bias is None else bias.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if dbias is None else dbias.data_ptr(),
            b, num_heads, lq, lk, d, plan.rows, plan.threads, plan.split,
            ctypes.addressof(st), scale * LOG2E, scale, None if ws is None else ws.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, "flash_attn_fp32_bwd_dkv", key)
    _count("dkv", "K3c", key, q.dtype)
    return dk, dv, dbias


def flash_backward_cuda(q, k, v, key_bias, o, do, lse, num_heads: int, scale=None,
                        need_dbias: bool = False):
    """delta from the saved o, then the dq and dk/dv kernels of q's dtype.
    Returns (dq, dk, dv, dbias per head or None)."""
    _check_operand(o, "o", q.device, q.shape[0], q.shape[2], q.dtype)
    delta = row_delta(o, do, num_heads)
    dq = flash_bwd_dq_cuda(q, k, v, key_bias, do, lse, delta, num_heads, scale)
    dk, dv, dbias = flash_bwd_dkv_cuda(q, k, v, key_bias, do, lse, delta, num_heads, scale,
                                       need_dbias)
    return dq, dk, dv, dbias


# ------------------------------------------------------------------ autograd
def _einsum_vjp(q, k, v, key_bias, do, num_heads: int, scale: float):
    """Gradients of `reference_attention` (the `ADAFACE_FLASH_BWD=einsum`
    arm): (dq, dk, dv, dbias or None)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        bias = None if key_bias is None else key_bias.detach().requires_grad_(True)
        out = reference_attention(*leaves, num_heads, bias, scale)
        grads = torch.autograd.grad(out, leaves + ([bias] if bias is not None else []), do)
    return tuple(grads) + ((None,) if bias is None else ())


class FlashAttentionBLC(torch.autograd.Function):
    """Packed flash attention with the flash backward: the CUDA kernels of
    the operands' dtype (bf16 or fp32) on a CUDA tensor, their plain versions
    on a CPU tensor. Saves q, k, v, bias,
    o and the row lse; dbias is returned only when the bias needs a
    gradient (summed over heads, as `_flash_core_blc3_bwd` does)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, num_heads: int, scale: float, arm: str,
                flags: int):
        if q.device.type == "cuda":
            out, lse = flash_attention_blc_cuda(q, k, v, num_heads, key_bias, scale,
                                                return_lse=True, arm=arm, flags=flags)
        else:
            out = flash_attention_blc_plain(q, k, v, num_heads, key_bias, scale,
                                            flags).to(q.dtype)
            lse = row_lse_plain(q, k, num_heads, key_bias, scale)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        need_db = key_bias is not None and ctx.needs_input_grad[3]
        if _use_einsum_bwd():
            dq, dk, dv, dbias = _einsum_vjp(q, k, v, key_bias, do, ctx.num_heads, ctx.scale)
            return dq, dk, dv, dbias if need_db else None, None, None, None, None
        if q.device.type == "cuda":
            dq, dk, dv, db = flash_backward_cuda(q, k, v, key_bias, out, do.contiguous(),
                                                 lse, ctx.num_heads, ctx.scale,
                                                 need_dbias=need_db)
        else:
            dq, dk, dv, db = flash_backward_plain(q, k, v, key_bias, out, do, lse,
                                                  ctx.num_heads, ctx.scale)
            dq, dk, dv = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
        dbias = db.sum(dim=1).to(key_bias.dtype) if need_db else None
        return dq, dk, dv, dbias, None, None, None, None


def _flash(q, k, v, key_bias, num_heads: int, scale: float, arm: str, flags: int):
    """The packed kernel's function at the given arm: through the autograd
    Function when autograd records, else the kernel (CUDA) or its plain
    version (CPU)."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no attention path for device {q.device}")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, key_bias))
    if needs_grad:
        return FlashAttentionBLC.apply(q, k, v, key_bias, num_heads, scale, arm, flags)
    if q.device.type == "cuda":
        return flash_attention_blc_cuda(q, k, v, num_heads, key_bias, scale, arm=arm,
                                        flags=flags)
    return flash_attention_blc_plain(q, k, v, num_heads, key_bias, scale,
                                     flags).to(q.dtype)


def flash_attention_blc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, key_bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention on packed q [B, Lq, H*D], k/v [B, Lk, H*D]; optional
    additive key bias [B, Lk]. Returns [B, Lq, H*D] in q's dtype."""
    b, lq, inner = q.shape
    lk = k.shape[1]
    arm = forward_arm(lq, lk)
    if arm == "einsum":
        return reference_attention(q, k, v, num_heads, key_bias, scale)
    scale = (inner // num_heads) ** -0.5 if scale is None else scale
    if lk < MIN_KERNEL_LEN:  # ADAFACE_FLASH_CROSS=1: pad the keys as JAX does
        pad = cross_pad_len(lk) - lk
        kb = (key_bias.float() if key_bias is not None
              else torch.zeros((b, lk), dtype=torch.float32, device=q.device))
        key_bias = F.pad(kb, (0, pad), value=-1e30)
        k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    flags = k1_flags() if arm == "K1" else 0
    return _flash(q, k, v, key_bias, num_heads, scale, arm, flags)


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int,
                        key_bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention on a fused [B, L, 3*H*D] projection (q | k | v along
    the last axis); the thirds go to the kernel as strided views."""
    inner = qkv.shape[-1] // 3
    return flash_attention_blc(qkv[..., :inner], qkv[..., inner:2 * inner],
                               qkv[..., 2 * inner:], num_heads, key_bias=key_bias,
                               scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention on q [B, H, Lq, D], k/v [B, H, Lk, D] with an optional
    additive key bias [B, Lk]: the einsum path below MIN_KERNEL_LEN, else
    K6 or K7 (`bhld_arm`) as a one-head packed call on [B*H, L, D]. Returns
    [B, H, Lq, D] in q's dtype."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    arm = bhld_arm(lq, lk)
    if arm == "einsum":
        return reference_attention_bhld(q, k, v, key_bias, scale)
    # ADAFACE_FLASH_HOST_PAD=1 zero-pads D to a multiple of 128 in JAX, a TPU
    # lane layout in HBM that leaves the function unchanged: the unpadded
    # kernel computes it under either setting.
    fold = lambda t: t.reshape(b * h, t.shape[2], d)
    bias = None if key_bias is None else key_bias.float().repeat_interleave(h, dim=0)
    out = _flash(fold(q), fold(k), fold(v), bias, 1, scale, arm, 0)
    return out.reshape(b, h, lq, d)
