"""Winograd F(2x2, 3x3) stride-1 SAME 3x3 convolution, NHWC in and out
(counterpart of `adaface_tpu/ops/winograd.py`).

- `conv3x3_same(x, kernel HWIO, bias, enabled)`: the Winograd op where
  `enabled` and `winograd_eligible` (the JAX gates verbatim: the
  `ADAFACE_WINOGRAD` mode "0" (default, never), "1" (wherever the shape and
  the `ADAFACE_WINOGRAD_VMEM` budget allow) or "auto" (also
  `ADAFACE_WINOGRAD_MIN_TILES` and 128-wide channels), even H and W) admit
  the shape; else `direct_conv3x3`. Nothing in the UNet calls it, as in
  JAX: the op is its own entry point.
- `winograd_conv3x3`: the op. On a CUDA tensor the hand-written Hopper
  kernel that replaces the TPU kernel `_wino_kernel`, `csrc/winograd.cu` in
  bf16 and `csrc/winograd_fp32.cu` in fp32 (FFMA products), on a CPU
  tensor its plain version `winograd_conv3x3_plain`. The gradient
  is the direct conv's VJP plus dbias = sum of g in fp32 (`_wino_bwd`), in
  plain torch ops, as XLA computes it outside Pallas.

The kernel's function, in `_wino_kernel`'s roundings: U = G g G^T in fp32,
cast to the kernel's dtype; for each of the 16 positions (i, j) the input
transform t_ij = sum of +-x over the 4x4 tile, accumulated in the input
dtype and rounded after every add, in the p-then-q loop order; m_ij = t_ij
U_ij with fp32 accumulation; y = A^T m A summed in fp32; + bias in fp32; one
cast.

`launch_plan` splits the bf16 kernel's product launch where its grid would
leave SMs idle, and `plan_items` lists the work items it then runs;
`fp32_launch_plan` picks the fp32 kernel's path (narrow in where Cin is 4,
narrow out where Cout is 4, else the general GEMMs) and split, and
`fp32_plan_items` lists the general path's work items;
`winograd_conv3x3_split_plain` is the plain version of a split launch (fp32
partials summed in slice order; `split_partials(..., k_tile)` with the
kernel's step width).

The public op keeps each leaf weight's transformed layout (`kernel_layout`,
keyed on the tensor, its storage, dtype, shape, device and version counter,
so that an updated weight is transformed again).

`launches_by_shape` counts kernel calls (each one C entry call: its
transform, product and sum launches, or one narrow launch) per (dtype, B,
H, W, Cin, Cout), dtype "bf16" or "fp32"; callers may clear it to count one
run.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from adaface_tpu_torch import kernels, knobs
from adaface_tpu_torch.device import sm_count

# F(2x2, 3x3) transform matrices (Lavin & Gray, arXiv:1509.09308):
#   y = AT [ (G g GT) * (BT d B) ] A  for a 4x4 input tile d, 3x3 filter g
BT = ((1, 0, -1, 0),
      (0, 1, 1, 0),
      (0, -1, 1, 0),
      (0, 1, 0, -1))
AT = ((1, 1, 1, 0),
      (0, 1, -1, -1))
G = np.array([[1.0, 0.0, 0.0],
              [0.5, 0.5, 0.5],
              [0.5, -0.5, 0.5],
              [0.0, 0.0, 1.0]], np.float32)
# the product kernel's tiles: M_TILE tile rows x N_TILE output columns a
# work item, K_TILE channels a step; Cin is zero-padded to a multiple of
# K_TILE (one 128-byte swizzled row of bf16), Cout to a multiple of N_TILE
M_TILE, N_TILE, K_TILE = 128, 64, 64
# launch_plan's cost model (H100 SXM): a step (a [128, 64] V box and a [64,
# 64] U box, 24 KB) at an SM's share of ~8 TB/s of L2 reads, the rate K9's
# copies measured (PERF.md section 6), which paces the products more than the
# tensor cores' 1 M multiply-adds a step; an item's ring fill and epilogue
# about 4 steps; a split's fp32 partials written and read once at 3.35 TB/s
_STEP_S = 24576 / (8e12 / 132)
_ITEM_OVERHEAD_STEPS = 4
_PEAK_BYTES = 3.35e12
DEF_MIN_TILES = 256
DEF_VMEM_BUDGET = 72 * 1024 * 1024

# The fp32 kernel (csrc/winograd_fp32.cu): its paths, the general path's
# tile (FP32_ROWS tile rows by FP32_N_TILE output columns, one CTA an SM,
# steps of FP32_BK channels; Cin padded to a multiple of FP32_BK) and
# splits. The narrow paths (Cin 4, Cout 4) take no split.
FP32_GENERAL, FP32_NARROW_IN, FP32_NARROW_OUT = 0, 1, 2
FP32_BK = 16
FP32_ROWS, FP32_N_TILE = 128, 64
FP32_MAX_SPLIT = 16
# The plan's time model of the general path: a tile's ring fill and
# epilogue, in steps; the products' share of the fp32 non-tensor peak an
# SM, fitted to `wino_variants.py --fp32` on an H100 (PERF.md section 6, PR
# 18: the whole op at 38-42% of its bound at the large shapes), where the
# model's split is the fastest of the forced splits 1-4 (and 6) at all 13
# general UNet shapes.
_FP32_TILE_OVERHEAD = 4
_FP32_RATE = 0.42
_PEAK_FP32_FLOPS_PER_SM = 67e12 / 132

launches_by_shape: Dict[Tuple[str, int, int, int, int, int], int] = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> (library, argument types), as declared in csrc/<library>.cu
C_ENTRIES = {
    "winograd_conv3x3_fwd": ("winograd", [_P] * 6 + [_I] * 9 + [_P]),
    "winograd_conv3x3_fp32_fwd": ("winograd_fp32", [_P] * 6 + [_I] * 8 + [_P]),
}


def transform_weights(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, Cin, Cout] -> U [16, Cin, Cout] (U_ij = (G g G^T)_ij),
    computed in fp32 and cast to the kernel's dtype."""
    g = torch.from_numpy(G).to(kernel.device)
    u = torch.einsum("pa,qb,abio->pqio", g, g, kernel.float())
    return u.reshape(16, kernel.shape[2], kernel.shape[3]).to(kernel.dtype)


def direct_conv3x3(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """stride-1 SAME 3x3 conv (+ bias) of NHWC x with an HWIO kernel cast to
    x's dtype."""
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)  # OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _input_tiles(x: torch.Tensor):
    """P(p, q) [B, H/2, W/2, Cin]: element (p, q) of every 4x4 input tile of
    the SAME-padded x (tile (r, s) starts at padded row 2r, column 2s)."""
    b, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return lambda p, q: xp[:, p:p + h:2, q:q + w:2, :]


def _input_transform(tile, i: int, j: int) -> torch.Tensor:
    """t_ij of every tile: the +-sum of the tile elements (p, q) that B^T
    picks, accumulated in the tiles' dtype and rounded after every add, in
    `_wino_kernel`'s p-then-q order."""
    t = None
    for p in range(4):
        if BT[i][p] == 0:
            continue
        for q in range(4):
            if BT[j][q] == 0:
                continue
            term = tile(p, q) if BT[i][p] * BT[j][q] > 0 else -tile(p, q)
            t = term if t is None else t + term
    return t


def winograd_conv3x3_plain(x: torch.Tensor, u: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops, from the transformed weights
    U [16, Cin, Cout] (x's dtype) and bias [Cout]: t_ij accumulated in x's
    dtype term by term, fp32 products (fp64 for fp64 inputs), y and the
    bias in fp32, one cast to x's dtype."""
    b, h, w, cin = x.shape
    cout = u.shape[-1]
    cdt = torch.promote_types(x.dtype, torch.float32)
    tile = _input_tiles(x)
    y = [[None, None], [None, None]]
    for i in range(4):
        for j in range(4):
            t = _input_transform(tile, i, j)
            m = torch.matmul(t.reshape(-1, cin).to(cdt), u[4 * i + j].to(cdt))
            for a in range(2):
                for c in range(2):
                    if AT[a][i] * AT[c][j] == 0:
                        continue
                    term = m if AT[a][i] * AT[c][j] > 0 else -m
                    y[a][c] = term if y[a][c] is None else y[a][c] + term
    out = torch.stack([torch.stack([y[a][c] for c in range(2)]) for a in range(2)])
    out = out + bias.to(cdt)
    # [a, c, B*hh*wh, Cout] -> [B, 2r + a, 2s + c, Cout]
    out = out.reshape(2, 2, b, h // 2, w // 2, cout).permute(2, 3, 0, 4, 1, 5)
    return out.reshape(b, h, w, cout).to(x.dtype)


# ------------------------------------------------------------- CUDA wrapper
def _fn(name: str):
    """The ctypes entry `name` of its library, with its signature set."""
    return kernels.entry(name, *C_ENTRIES[name])


def padded_weights(u: torch.Tensor) -> torch.Tensor:
    """U [16, Cin, Cout] as the bf16 product kernel reads it: transposed to
    K-major [16, Cout_p, Cin_p] and zero-padded to the tile multiples."""
    _, cin, cout = u.shape
    cin_p = -(-cin // K_TILE) * K_TILE
    cout_p = -(-cout // N_TILE) * N_TILE
    return F.pad(u.transpose(1, 2), (0, cin_p - cin, 0, cout_p - cout)).contiguous()


def padded_weights_fp32(u: torch.Tensor) -> torch.Tensor:
    """U [16, Cin, Cout] as the fp32 kernel reads it (every path): transposed
    to K-major [16, Cout, Cin_p], Cin zero-padded to a multiple of
    FP32_BK."""
    cin = u.shape[1]
    return F.pad(u.transpose(1, 2), (0, -(-cin // FP32_BK) * FP32_BK - cin)).contiguous()


class LaunchPlan(NamedTuple):
    split: int  # slices of the 16 * Cin_p / K_TILE product steps
    m_fastest: bool  # row blocks fastest in the grid (else column blocks)
    grid: int  # CTAs of the product launch, one work item each


@functools.lru_cache(maxsize=None)  # a pure function of ints, asked once a call
def launch_plan(m: int, cin: int, cout: int, sms: int) -> LaunchPlan:
    """The product launch's plan for M tiles, Cin -> Cout on a card of `sms`
    SMs (one 384-thread CTA an SM). The split is the one that minimises
    waves x (steps an item + an item's overhead) x a step's time, plus the
    time of the partials' bytes: it splits only where the unsplit grid
    leaves SMs idle in its last wave. CTAs that run together share the
    operand that is re-read across the grid: V's rows (column blocks
    fastest) where U is the smaller, U's columns where V is.

    Tiles of 64 rows x 128 columns move the same bytes per product as 128 x
    64 (both read (rows + columns) x 64 channels a step), so the plan keeps
    one tile shape."""
    cin_p = -(-cin // K_TILE) * K_TILE
    cout_p = -(-cout // N_TILE) * N_TILE
    tiles = -(-m // M_TILE) * (cout_p // N_TILE)
    steps = 16 * (cin_p // K_TILE)

    def cost(split):
        extra = 0.0 if split == 1 else 2 * 4 * split * 4 * m * cout_p / _PEAK_BYTES
        waves = -(-tiles * split // sms)
        return waves * (-(-steps // split) + _ITEM_OVERHEAD_STEPS) * _STEP_S + extra

    split = min(range(1, min(16, steps) + 1), key=cost)
    return LaunchPlan(split, m < cout_p, tiles * split)


class WorkItem(NamedTuple):
    row0: int  # first tile row (rows past M are masked)
    col0: int  # first output column
    k0: int  # product steps [k0, k1): step st is position st // nk, channels
    k1: int  #   [st % nk * K_TILE, + K_TILE), nk = Cin_p / K_TILE
    slice: int


def plan_items(m: int, cin: int, cout: int, plan: LaunchPlan) -> List[WorkItem]:
    """The work item of each CTA of the product launch, in block order, as
    `wino_product_kernel` (csrc/winograd.cu: `decode`) takes them: the
    slice slowest, then the column block (m_fastest) or the row block."""
    cout_p = -(-cout // N_TILE) * N_TILE
    mblk, nblk = -(-m // M_TILE), cout_p // N_TILE
    steps = 16 * -(-cin // K_TILE)
    items = []
    for item in range(plan.grid):
        s, tile = divmod(item, mblk * nblk)
        nb, mb = divmod(tile, mblk) if plan.m_fastest else reversed(divmod(tile, nblk))
        items.append(WorkItem(mb * M_TILE, nb * N_TILE, s * steps // plan.split,
                              (s + 1) * steps // plan.split, s))
    return items


def split_partials(x: torch.Tensor, u: torch.Tensor, split: int,
                   k_tile: int = K_TILE) -> torch.Tensor:
    """The kernel's fp32 quadrants [split, 2, 2, M, Cout] of each slice of
    the 16 * Cin_p / k_tile product steps (x's promoted dtype for fp64),
    in plain torch ops: t_ij as `winograd_conv3x3_plain` rounds it, each
    step's product added with its A^T signs. k_tile: the kernel's channels
    a step (K_TILE bf16, FP32_BK fp32)."""
    b, h, w, cin = x.shape
    cout = u.shape[-1]
    cdt = torch.promote_types(x.dtype, torch.float32)
    nk = -(-cin // k_tile)
    steps = 16 * nk
    tile = _input_tiles(x)
    t = [_input_transform(tile, ij // 4, ij % 4).reshape(-1, cin).to(cdt) for ij in range(16)]
    parts = torch.zeros((split, 2, 2, t[0].shape[0], cout), dtype=cdt, device=x.device)
    for s in range(split):
        for st in range(s * steps // split, (s + 1) * steps // split):
            ij, kc = divmod(st, nk)
            ks = slice(kc * k_tile, (kc + 1) * k_tile)
            mm = torch.matmul(t[ij][:, ks], u[ij, ks].to(cdt))
            for a in range(2):
                for c in range(2):
                    coef = AT[a][ij // 4] * AT[c][ij % 4]
                    if coef:
                        parts[s, a, c] += coef * mm
    return parts


class FP32Plan(NamedTuple):
    """The fp32 kernel's path and split."""
    path: int  # FP32_GENERAL, FP32_NARROW_IN or FP32_NARROW_OUT
    split: int  # general: slices of the steps; narrow paths: 1


def fp32_path(cin: int, cout: int) -> int:
    """The path the fp32 kernel takes for Cin -> Cout: narrow in where Cin is
    4, narrow out where Cout is 4 (and Cin a multiple of 4), else general."""
    if cin == 4:
        return FP32_NARROW_IN
    if cout == 4 and cin % 4 == 0:
        return FP32_NARROW_OUT
    return FP32_GENERAL


def fp32_steps(cin: int) -> int:
    """The general path's steps: 16 positions x Cin_p / FP32_BK channel
    stages."""
    return 16 * -(-cin // FP32_BK)


def fp32_product_seconds(m: int, cin: int, cout: int, sms: int, split: int) -> float:
    """The plan's time model of the general path's product launch on `sms`
    SMs (one CTA each): waves of tiles, each as long as its steps (plus a
    tile's overhead) at the fitted share of the FFMA peak, plus the
    partials' bytes (written, then read by the sum) at the memory's peak."""
    tiles = -(-m // FP32_ROWS) * -(-cout // FP32_N_TILE) * split
    steps = fp32_steps(cin)
    step = 2 * FP32_ROWS * FP32_N_TILE * FP32_BK / (_PEAK_FP32_FLOPS_PER_SM * _FP32_RATE)
    extra = 0.0 if split == 1 else 2 * 16 * split * m * cout / _PEAK_BYTES
    return -(-tiles // sms) * (steps / split + _FP32_TILE_OVERHEAD) * step + extra


@functools.lru_cache(maxsize=256)
def fp32_launch_plan(m: int, cin: int, cout: int, sms: int,
                     path: Optional[int] = None) -> FP32Plan:
    """The fp32 kernel's plan for M tiles, Cin -> Cout on a card of `sms`
    SMs: `fp32_path`'s path (or `path`, forced); on the general path the
    split that minimises `fp32_product_seconds` (ties to fewer slices), so
    it splits only where the unsplit tiles leave SMs idle; the narrow paths
    split 1."""
    path = fp32_path(cin, cout) if path is None else path
    if path != FP32_GENERAL:
        return FP32Plan(path, 1)
    steps = fp32_steps(cin)
    return FP32Plan(path, min(range(1, min(FP32_MAX_SPLIT, steps) + 1),
                              key=lambda s: (fp32_product_seconds(m, cin, cout, sms, s), s)))


def fp32_plan_ok(plan: FP32Plan, cin: int, cout: int) -> bool:
    """Whether the fp32 C entry takes `plan` for Cin -> Cout (it refuses
    the rest with cudaErrorInvalidValue)."""
    if plan.path == FP32_NARROW_IN:
        return cin == 4 and plan.split == 1
    if plan.path == FP32_NARROW_OUT:
        return cout == 4 and cin % 4 == 0 and plan.split == 1
    return plan.path == FP32_GENERAL and 1 <= plan.split <= min(FP32_MAX_SPLIT, fp32_steps(cin))


def fp32_plan_items(m: int, cin: int, cout: int, split: int) -> List[WorkItem]:
    """The general path's work items in grid order, as `wino32_product`
    (csrc/winograd_fp32.cu) takes them: CTA t's slice t % split, then column
    blocks, then row blocks; slice s covers steps [s*S/split, (s+1)*S/split)
    of the S = `fp32_steps(Cin)` (step st: position st // nk, channels
    [st % nk * FP32_BK, + FP32_BK), nk = Cin_p / FP32_BK)."""
    nrow, ncol = -(-m // FP32_ROWS), -(-cout // FP32_N_TILE)
    steps = fp32_steps(cin)
    items = []
    for t in range(nrow * ncol * split):
        s, nb, mb = t % split, t // split % ncol, t // split // ncol
        items.append(WorkItem(mb * FP32_ROWS, nb * FP32_N_TILE, s * steps // split,
                              (s + 1) * steps // split, s))
    return items


def winograd_conv3x3_split_plain(x: torch.Tensor, parts: torch.Tensor,
                                 bias: torch.Tensor) -> torch.Tensor:
    """The split launch's function in plain torch ops: the slices' partials
    (`split_partials(x, U, split)`) summed in slice order, + bias in fp32,
    one cast to x's dtype, NHWC."""
    b, h, w, _ = x.shape
    cout = parts.shape[-1]
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    y = y + bias.to(y.dtype)
    y = y.reshape(2, 2, b, h // 2, w // 2, cout).permute(2, 3, 0, 4, 1, 5)
    return y.reshape(b, h, w, cout).to(x.dtype)


def winograd_conv3x3_cuda(x: torch.Tensor, ut: torch.Tensor, bias: torch.Tensor,
                          split: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors of one dtype, bf16
    (`csrc/winograd.cu`) or fp32 (`csrc/winograd_fp32.cu`): x NHWC [B, H, W,
    Cin] (H, W even), the weights as the kernel reads them (bf16
    `padded_weights(U)` [16, Cout_p, Cin_p], fp32 `padded_weights_fp32(U)`
    [16, Cout, Cin_p]), bias [Cout]; `split` forces the split of the plan
    (`launch_plan`'s, `fp32_launch_plan`'s; the fp32 narrow paths take 1
    alone); raises on anything it does not take."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA kernels take bfloat16 or float32, x is {x.dtype}")
    for t, name in ((ut, "ut"), (bias, "bias")):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"the CUDA kernel takes {x.dtype} on {x.device}; {name} is "
                            f"{t.dtype} on {t.device}")
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}, not a CUDA device")
    if x.dim() != 4 or bias.dim() != 1:
        raise ValueError(f"want x [B, H, W, Cin] and bias [Cout], got {tuple(x.shape)} and "
                         f"{tuple(bias.shape)}")
    b, h, w, cin = x.shape
    cout = bias.shape[0]
    fp32 = x.dtype == torch.float32
    if fp32:
        cin_p, cout_p, what = -(-cin // FP32_BK) * FP32_BK, cout, "padded_weights_fp32"
    else:
        cin_p, cout_p, what = -(-cin // K_TILE) * K_TILE, -(-cout // N_TILE) * N_TILE, \
            "padded_weights"
    if tuple(ut.shape) != (16, cout_p, cin_p) or not ut.is_contiguous():
        raise ValueError(f"want ut = {what}(U), contiguous [16, {cout_p}, {cin_p}]; got "
                         f"{tuple(ut.shape)}")
    if h % 2 or w % 2 or b * h * w == 0:
        raise ValueError(f"the kernel takes even, non-empty H and W; got x {tuple(x.shape)}")
    x = x.contiguous()
    bias = bias.contiguous()
    m = b * (h // 2) * (w // 2)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    key = (b, h, w, cin, cout)
    if fp32:
        plan = fp32_launch_plan(m, cin, cout, sm_count(x.device.index))
        if split is not None:
            plan = plan._replace(split=split)
            if not fp32_plan_ok(plan, cin, cout):
                raise ValueError(f"the fp32 kernel's path {plan.path} takes no split {split} "
                                 f"at Cin {cin}, Cout {cout}")
        general = plan.path == FP32_GENERAL
        v = torch.empty((16, m, cin_p), dtype=x.dtype, device=x.device) if general else None
        ws = (torch.empty((plan.split, 4, m, cout), dtype=x.dtype, device=x.device)
              if general and plan.split > 1 else None)
        name, tag = "winograd_conv3x3_fp32_fwd", "fp32"
        with torch.cuda.device(x.device):
            err = _fn(name)(x.data_ptr(), ut.data_ptr(), bias.data_ptr(),
                            None if v is None else v.data_ptr(),
                            None if ws is None else ws.data_ptr(), out.data_ptr(), b, h, w, cin,
                            cout, cin_p, *plan, stream)
    else:
        v = torch.empty((16, m, cin_p), dtype=x.dtype, device=x.device)
        plan = launch_plan(m, cin, cout, sm_count(x.device.index))
        if split is not None:
            if not 1 <= split <= 16 * (cin_p // K_TILE):
                raise ValueError(f"split {split} outside 1..{16 * (cin_p // K_TILE)}")
            plan = plan._replace(split=split)
        ws = (torch.empty((plan.split, 4, m, cout_p), dtype=torch.float32, device=x.device)
              if plan.split > 1 else None)
        name, tag = "winograd_conv3x3_fwd", "bf16"
        with torch.cuda.device(x.device):
            err = _fn(name)(x.data_ptr(), ut.data_ptr(), bias.data_ptr(), v.data_ptr(),
                            0 if ws is None else ws.data_ptr(), out.data_ptr(), b, h, w, cin,
                            cout, cin_p, cout_p, plan.split, int(plan.m_fastest), stream)
    if err:
        raise RuntimeError(f"{name} failed: CUDA error {err} (B, H, W, Cin, Cout = {key})")
    launches_by_shape[(tag,) + key] = launches_by_shape.get((tag,) + key, 0) + 1
    return out


# ------------------------------------------------------------------ autograd
class WinogradConv3x3(torch.autograd.Function):
    """The kernel (CUDA) or its plain version (CPU) forward on the
    transformed weights; the backward is the direct conv's VJP and the fp32
    bias sum (`_wino_bwd`)."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        return _winograd_forward(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            kk = kernel.detach().requires_grad_(True)
            dx, dk = torch.autograd.grad(direct_conv3x3(xx, kk), (xx, kk), g)
        dbias = g.float().sum(dim=(0, 1, 2)).to(g.dtype)
        return dx, dk, dbias


# (id, storage, dtype, shape, device) of a leaf weight tensor -> (a weak
# reference to it, its version counter, its layout); the most recent
# _LAYOUT_CACHE_SIZE weights
_layouts: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_LAYOUT_CACHE_SIZE = 64


def kernel_layout(kernel: torch.Tensor) -> torch.Tensor:
    """The weights of an HWIO kernel as the op reads them: on a CUDA tensor
    the kernel's layout (`padded_weights_fp32` in fp32, `padded_weights` in
    bf16) of U = `transform_weights(kernel)`, on a CPU tensor U. Kept per
    leaf weight tensor (a parameter, or a tensor that takes no gradient) and
    served again while it is the same tensor object, on the same storage,
    dtype, shape and device, at the same version counter (an in-place
    update, e.g. an optimizer step, makes it anew; one made through
    `.data` moves no version counter and is not seen). A tensor made under
    `torch.inference_mode` has no version counter, and a non-leaf (e.g. a
    cast of a parameter under autograd, which the backward keeps alive) is
    made anew each forward: the layout of both is made every call."""
    keep = kernel.is_leaf and not kernel.is_inference()
    key = (id(kernel), kernel.data_ptr(), kernel.dtype, tuple(kernel.shape),
           kernel.device) if keep else None
    hit = _layouts.get(key)
    if hit is not None and hit[0]() is kernel and hit[1] == kernel._version:
        _layouts.move_to_end(key)
        return hit[2]
    with torch.no_grad():
        u = transform_weights(kernel.detach())
        if kernel.device.type == "cuda":
            u = padded_weights_fp32(u) if kernel.dtype == torch.float32 else padded_weights(u)
    if key is not None:
        # the entry goes when its weight does
        _layouts[key] = (weakref.ref(kernel, lambda _, key=key: _layouts.pop(key, None)),
                         kernel._version, u)
        _layouts.move_to_end(key)
        while len(_layouts) > _LAYOUT_CACHE_SIZE:
            _layouts.popitem(last=False)
    return u


def _winograd_forward(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel (CUDA) or its plain version (CPU) on `kernel_layout`."""
    u = kernel_layout(kernel)
    if x.device.type == "cuda":
        return winograd_conv3x3_cuda(x, u, bias)
    return winograd_conv3x3_plain(x, u, bias)


def winograd_conv3x3(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """stride-1 SAME 3x3 conv of NHWC x (H, W even) with an HWIO kernel and
    a [Cout] bias, all of one dtype (bf16 or fp32 on the card), by the
    Winograd kernel."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no Winograd path for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, bias)):
        return WinogradConv3x3.apply(x, kernel, bias)
    return _winograd_forward(x, kernel, bias)


def vmem_estimate(h: int, w: int, cin: int, cout: int, itemsize: int) -> int:
    """The JAX package's per-image VMEM estimate of its TPU kernel (its
    `_vmem_estimate`), which the gates hold against the budget."""
    hh, wh = h // 2, w // 2
    tiles = hh * wh
    grids = 20 * (hh + 1) * (wh + 1) * cin * itemsize  # 4 blocks + 16 P slices
    weights = 16 * cin * cout * itemsize
    acc = 5 * tiles * cout * 4  # 4 y accumulators + live m, fp32
    out = 4 * tiles * cout * itemsize
    return grids + weights + acc + out


def winograd_eligible(x_shape, cout: int, itemsize: int = 2) -> bool:
    """The JAX dispatch gates, verbatim (read at call time)."""
    mode = knobs.get("ADAFACE_WINOGRAD", "0")
    if mode not in ("1", "auto"):
        return False
    b, h, w, cin = x_shape
    if h % 2 or w % 2:
        return False
    forced = mode == "1"
    min_tiles = int(knobs.get("ADAFACE_WINOGRAD_MIN_TILES", str(DEF_MIN_TILES)))
    if not forced and (h // 2) * (w // 2) < min_tiles:
        return False
    if not forced and (cin < 128 or cout < 128):  # lanes too thin
        return False
    budget = int(knobs.get("ADAFACE_WINOGRAD_VMEM", str(DEF_VMEM_BUDGET)))
    return vmem_estimate(h, w, cin, cout, itemsize) <= budget


def conv3x3_same(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 enabled: bool = True) -> torch.Tensor:
    """stride-1 SAME 3x3 conv; the Winograd op when `enabled` and the shape
    clears the gates, else `direct_conv3x3`."""
    if enabled and winograd_eligible(x.shape, kernel.shape[-1], x.element_size()):
        b = bias if bias is not None else torch.zeros(kernel.shape[-1], dtype=x.dtype,
                                                      device=x.device)
        return winograd_conv3x3(x, kernel.to(x.dtype), b.to(x.dtype))
    return direct_conv3x3(x, kernel, bias)
