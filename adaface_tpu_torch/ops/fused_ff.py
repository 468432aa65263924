"""Fused LayerNorm + GEGLU feed-forward + residual of the UNet transformer
blocks (counterpart of `adaface_tpu/ops/fused_ff.py`).

`ln_geglu_ff(x, ...)` = x + Linear(F -> C)(a * gelu_tanh(g)) with [a | g] =
Linear(C -> 2F)(LayerNorm(x)), weights in the JAX layout (w1 [C, 2F], w2
[F, C]; the UNet passes its nn.Linear weights transposed, as views).

- `ADAFACE_FUSED_FF` other than "1" (the default): `ln_geglu_ff_unfused`,
  the chain of torch ops the UNet ran before the knob existed
  (`F.layer_norm`, `F.linear`, GEGLU, `F.linear`, residual).
- `ADAFACE_FUSED_FF=1`: the kernel's function. On a bf16 CUDA tensor the
  hand-written Hopper kernels of `csrc/ln_geglu_ff.cu` (LayerNorm, GEMM1 +
  GEGLU, GEMM2 + residual, and a split-K sum where the plan splits GEMM2:
  the launches that replace the TPU kernel `_ff_kernel`; `launch_plan`
  chooses their tiles, split and grids), on an fp32 one (an fp32 pipeline)
  those of `csrc/ln_geglu_ff_fp32.cu` (the same steps on fp32 FFMA),
  on a CPU tensor its plain version `ln_geglu_ff_plain`, which is
  `_reference_ln_geglu_ff` with its roundings. `fp32_launch_plan` chooses
  the fp32 kernel's GEMM2 tile width and split of F.
  The gradient, `LnGegluFF`, saves only the inputs and recomputes through
  the plain chain (`_ff_core_bwd`), for the inputs that need one: the UNet's
  frozen weights get none.

`launches_by_shape` counts kernel calls per (dtype, B, L, C), dtype "bf16"
or "fp32"; callers may clear it to count one run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from adaface_tpu_torch import kernels, knobs
from adaface_tpu_torch.device import sm_count
from adaface_tpu_torch.ops.basic import geglu
from adaface_tpu_torch.ops.grad import recompute_grads

# C and F must be multiples of the GEMMs' K step (one 128-byte swizzle row)
KERNEL_COL_TILE = 64
KERNEL_MAX_C = 2048  # the LayerNorm launch holds a row in at most 32 lanes' registers
GEMM1_ROWS = 128  # rows per tile: two consumer warpgroups of 64 rows
GEMM2_ROWS = (256, 128)  # two 64-row slabs a warpgroup, or one
# A 256-row GEMM2 tile reads its B tile once for twice the rows: per
# product it measured 6-10% faster than 128-row tiles on an H100 (PERF.md).
_SLAB_GAIN = 0.9
MAX_SPLIT = 8
# What GEMM2's tile and split choice weighs (H100 SXM data sheet): a K step
# of one tile (rows x bn2 x 64) at the tensor cores' peak per SM, and the
# fp32 partials written and read again at the memory's peak.
_PEAK_FLOPS_PER_SM = 989e12 / 132
_PEAK_BYTES = 3.35e12
_ITEM_OVERHEAD_STEPS = 4  # an item's ring fill and epilogue, in K steps


class LaunchPlan(NamedTuple):
    """Tiles, GEMM2's split of F and the persistent grids of one call."""
    bn1: int  # h columns per GEMM1 tile (its B tile holds their value and gate rows)
    bn2: int  # output columns per GEMM2 tile
    rows2: int  # rows per GEMM2 tile
    split: int  # GEMM2's K (F) ranges, summed in order by a reduction launch
    grid1: int
    grid2: int


@functools.lru_cache(maxsize=256)
def launch_plan(m: int, c: int, f: int, sms: int) -> LaunchPlan:
    """The launch plan for x [m, c] and hidden width f on a card of `sms`
    SMs. GEMM2 takes 160 columns a tile where C allows (160 divides the
    UNet's 320, 640 and 1280); its rows a tile and its split of F are those
    that minimise waves x (K steps per item + an item's overhead) x a K
    step's time, plus the time of the partials' extra bytes, so that few rows
    take smaller or split tiles to fill the card."""
    bn1 = 128 if f % 128 == 0 else 64
    bn2 = next(n for n in (160, 128, 64) if c % n == 0)
    items1 = -(-m // GEMM1_ROWS) * (f // bn1)
    ksteps = f // KERNEL_COL_TILE

    def cost(plan):
        rows, split = plan
        items = -(-m // rows) * (c // bn2) * split
        t_step = rows * bn2 * KERNEL_COL_TILE * 2 / _PEAK_FLOPS_PER_SM
        t_step *= _SLAB_GAIN if rows == 256 else 1.0
        extra = 0.0 if split == 1 else 2 * 4 * m * c * split / _PEAK_BYTES
        return -(-items // sms) * (-(-ksteps // split) + _ITEM_OVERHEAD_STEPS) * t_step + extra

    # splits take 128-row tiles: where 256-row tiles need a split, rows are few
    rows2, split = min([(256, 1)] + [(128, s) for s in range(1, min(MAX_SPLIT, ksteps) + 1)],
                       key=cost)
    items2 = -(-m // rows2) * (c // bn2) * split
    return LaunchPlan(bn1, bn2, rows2, split, min(items1, sms), min(items2, sms))


class WorkItem(NamedTuple):
    row0: int  # first row of the tile (rows past M are masked)
    col0: int  # first output column (GEMM1: h column; its gate row is F + col0)
    k0: int  # contraction range [k0, k1) in elements
    k1: int
    split: int  # index of the K range


def gemm_items(m: int, n: int, k: int, rows: int, bn: int, split: int,
               grid: int) -> List[List[WorkItem]]:
    """The work items of each CTA of a persistent GEMM launch, in the order
    `gemm_kernel` (csrc/ln_geglu_ff.cu: `decode`) takes them: CTA b walks
    items b, b + grid, ...; an item's split is fastest, then its column
    block, then its block of `rows` rows; split s covers K steps
    [s*K/split, (s+1)*K/split) of 64 columns."""
    nblk, ksteps = n // bn, k // KERNEL_COL_TILE
    items = -(-m // rows) * nblk * split
    out = []
    for b in range(grid):
        mine = []
        for item in range(b, items, grid):
            s, tile = item % split, item // split
            nb, mb = tile % nblk, tile // nblk
            mine.append(WorkItem(mb * rows, nb * bn, s * ksteps // split * KERNEL_COL_TILE,
                                 (s + 1) * ksteps // split * KERNEL_COL_TILE, s))
        out.append(mine)
    return out


# The fp32 kernel (csrc/ln_geglu_ff_fp32.cu): 128-row FFMA tiles, stages of
# 16 K columns; GEMM1 tiles of 64 h columns (their value and gate rows).
FP32_ROWS = 128
FP32_BK = 16
FP32_H_COLS = 64
FP32_BN2 = (160, 128, 64)  # GEMM2's tile widths
FP32_MAX_SPLIT = 8
# GEMM2's CTAs an SM and FFMA rate an SM (relative to 160 columns, one CTA
# an SM) by tile width and whether it writes partials: 64 columns and
# unsplit 128 hold two CTAs an SM (<= 128 registers), 128 columns writing
# partials one (151 registers). Fitted to `ff_variants.py --fp32`'s grid of
# widths and splits on an H100 (PERF.md §6, the fp32 K9 steps), where the plan
# then picks the fastest of the 12 at all eight shapes of the fp32 paths.
_FP32_GEMM2_SLOTS = {(64, False): (2, 0.85), (64, True): (2, 0.85), (128, False): (2, 1.3),
                     (128, True): (1, 0.9), (160, False): (1, 1.0), (160, True): (1, 1.0)}
_FP32_TILE_OVERHEAD = 3  # a tile's ring fill and epilogue, in stages
_PEAK_FP32_FLOPS_PER_SM = 67e12 / 132


class FP32Plan(NamedTuple):
    """GEMM2's tile width and split of F."""
    bn2: int  # output columns a GEMM2 tile
    split: int  # GEMM2's K (F) ranges, summed in order by a second launch


def fp32_gemm2_seconds(m: int, c: int, f: int, sms: int, bn2: int, split: int) -> float:
    """The plan's time model of GEMM2 on `sms` SMs: waves of tiles, each as
    long as its SM's CTAs take for their stages (plus a tile's overhead) at
    the tile shape's rate, plus the partials' bytes (written, then read by
    the sum) at the memory's peak."""
    ctas, rate = _FP32_GEMM2_SLOTS[(bn2, split > 1)]
    tiles = -(-m // FP32_ROWS) * (c // bn2) * split
    waves = -(-tiles // (sms * ctas))
    stage = 2 * FP32_ROWS * bn2 * FP32_BK / (_PEAK_FP32_FLOPS_PER_SM * rate)
    extra = 0.0 if split == 1 else 8 * m * c * split / _PEAK_BYTES
    return waves * ctas * (f / split / FP32_BK + _FP32_TILE_OVERHEAD) * stage + extra


@functools.lru_cache(maxsize=256)
def fp32_launch_plan(m: int, c: int, f: int, sms: int) -> FP32Plan:
    """The fp32 kernel's plan for x [m, c] and hidden width f on a card of
    `sms` SMs: GEMM2's tile width (160, 128 or 64 columns, dividing c) and
    split of F that minimise `fp32_gemm2_seconds` (ties to fewer slices,
    then wider tiles)."""
    choices = [(bn, s) for bn in FP32_BN2 if c % bn == 0
               for s in range(1, min(FP32_MAX_SPLIT, f // FP32_BK) + 1)]
    return FP32Plan(*min(choices, key=lambda p: (fp32_gemm2_seconds(m, c, f, sms, *p), p[1],
                                                  -p[0])))


def fp32_gemm_tiles(m: int, n: int, k: int, bn: int, split: int,
                    geglu: bool = False) -> List[WorkItem]:
    """The work items of an fp32 GEMM launch in grid order, as
    `ff32_gemm_kernel` (csrc/ln_geglu_ff_fp32.cu) takes them: tile t's K
    range t % split, then column blocks fastest, then row blocks; split s
    covers K stages [s*S/split, (s+1)*S/split) of FP32_BK columns. GEMM1
    (`geglu`): n is F and a tile's columns are 64 h columns."""
    nrow, width = -(-m // FP32_ROWS), FP32_H_COLS if geglu else bn
    ncol, stages = n // width, k // FP32_BK
    items = []
    for t in range(nrow * ncol * split):
        s, nb, mb = t % split, t // split % ncol, t // split // ncol
        items.append(WorkItem(mb * FP32_ROWS, nb * width, s * stages // split * FP32_BK,
                              (s + 1) * stages // split * FP32_BK, s))
    return items

launches_by_shape: Dict[Tuple[str, int, int, int], int] = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> (library, argument types), as declared in csrc/<library>.cu
C_ENTRIES = {
    "ln_geglu_ff_fwd": ("ln_geglu_ff", [_P] * 11 + [_I] * 3 + [_F] + [_I] * 6 + [_P]),
    "ln_geglu_ff_fp32_fwd": ("ln_geglu_ff_fp32", [_P] * 11 + [_I] * 3 + [_F] + [_I] * 2 + [_P]),
}


def ln_geglu_ff_unfused(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5):
    """The torch chain the knob replaces: nn.LayerNorm (torch's statistics),
    nn.Linear (bias added before the cast), GEGLU, nn.Linear, residual."""
    y = F.layer_norm(x, x.shape[-1:], ln_scale, ln_bias, eps)
    return x + F.linear(geglu(F.linear(y, w1.t(), b1)), w2.t(), b2)


def ln_geglu_ff_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5):
    """The kernel's function in plain torch ops (`_reference_ln_geglu_ff`):
    one-pass fp32 LayerNorm statistics clamped at 0, the LN affine in fp32
    then a cast to x's dtype; u = (y . w1 in fp32) cast, plus b1; value and
    gate halves, a * gelu_tanh(g) cast; o = (h . w2 in fp32) cast, plus b2;
    x + o. Products run in fp32 (fp64 for fp64 inputs)."""
    dt = x.dtype
    cdt = torch.promote_types(dt, torch.float32)
    xf = x.to(cdt)
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, 0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = (y * ln_scale.to(cdt) + ln_bias.to(cdt)).to(dt)
    u = torch.matmul(y.to(cdt), w1.to(cdt)).to(dt) + b1.to(dt)
    a, g = u.chunk(2, dim=-1)
    h = (a * F.gelu(g, approximate="tanh")).to(dt)
    o = torch.matmul(h.to(cdt), w2.to(cdt)).to(dt) + b2.to(dt)
    return x + o


def _fn(name: str):
    """The ctypes entry `name` of its library, with its signature set."""
    return kernels.entry(name, *C_ENTRIES[name])


def _operand(t: torch.Tensor, shape: tuple, name: str, device, dtype) -> torch.Tensor:
    """`t` as a contiguous `dtype` tensor on `device`; a weight that arrives
    as the transpose of a contiguous tensor (nn.Linear's, as the UNet passes
    it) becomes that tensor again without a copy."""
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name} must be {list(shape)} on {device}, got "
                         f"{list(t.shape)} on {t.device}")
    t = t.detach().to(dtype).contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start 16-byte aligned, got {t.data_ptr():#x}")
    return t


def ln_geglu_ff_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5):
    """Launch the Hopper kernels on a CUDA x [B, L, C]: bf16 x on
    `csrc/ln_geglu_ff.cu` (operands cast to bf16), fp32 x on
    `csrc/ln_geglu_ff_fp32.cu` (operands cast to fp32); raises on anything
    they do not take."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA kernels take bfloat16 or float32, x is {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}, not a CUDA device")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, C], got {tuple(x.shape)}")
    b, l, c = x.shape
    f = w2.shape[0]
    if c % KERNEL_COL_TILE or f % KERNEL_COL_TILE or c > KERNEL_MAX_C or b * l == 0:
        raise ValueError(f"the kernel needs C and F multiples of {KERNEL_COL_TILE}, C <= "
                         f"{KERNEL_MAX_C} and rows; got x {tuple(x.shape)}, F {f}")
    dev, dt = x.device, x.dtype
    x = _operand(x, (b, l, c), "x", dev, dt)
    w1t = _operand(w1.t(), (2 * f, c), "w1^T", dev, dt)
    w2t = _operand(w2.t(), (c, f), "w2^T", dev, dt)
    vecs = [_operand(t, (n,), name, dev, dt) for t, n, name in
            ((ln_scale, c, "ln_scale"), (ln_bias, c, "ln_bias"), (b1, 2 * f, "b1"),
             (b2, c, "b2"))]
    m = b * l
    y = torch.empty_like(x)
    h = torch.empty((m, f), dtype=dt, device=dev)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dt == torch.float32:
        name, plan = "ln_geglu_ff_fp32_fwd", fp32_launch_plan(m, c, f, sm_count(dev.index))
    else:
        name, plan = "ln_geglu_ff_fwd", launch_plan(m, c, f, sm_count(dev.index))
    ws = (torch.empty((plan.split, m, c), dtype=torch.float32, device=dev)
          if plan.split > 1 else None)
    with torch.cuda.device(dev):  # both C entries: pointers, sizes, eps, the plan, stream
        err = _fn(name)(x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w1t.data_ptr(),
                        vecs[2].data_ptr(), w2t.data_ptr(), vecs[3].data_ptr(), y.data_ptr(),
                        h.data_ptr(), None if ws is None else ws.data_ptr(), out.data_ptr(), m,
                        c, f, eps, *plan, stream)
    if err:
        raise RuntimeError(f"{name} failed: CUDA error {err} (B, L, C, F = "
                           f"{b}, {l}, {c}, {f}; {plan})")
    key = ("fp32" if dt == torch.float32 else "bf16", b, l, c)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return out


class LnGegluFF(torch.autograd.Function):
    """The kernel (CUDA) or its plain version (CPU) forward; saves only the
    inputs, and the backward recomputes `ln_geglu_ff_plain` and
    differentiates it for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float):
        args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.save_for_backward(*args)
        ctx.eps = eps
        if x.device.type == "cuda":
            return ln_geglu_ff_cuda(*args, eps)
        return ln_geglu_ff_plain(*args, eps)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(lambda *a: ln_geglu_ff_plain(*a, ctx.eps), ctx.saved_tensors,
                               ctx.needs_input_grad[:7], g) + (None,)


def ln_geglu_ff(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x + FF(LN(x)), x [B, L, C], w1 [C, 2F] (value | gate), b1 [2F], w2
    [F, C], b2 [C]: the fused kernel under `ADAFACE_FUSED_FF=1`, else the
    unfused torch chain."""
    if knobs.get("ADAFACE_FUSED_FF") != "1":
        return ln_geglu_ff_unfused(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no ln_geglu_ff path for device {x.device}")
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return LnGegluFF.apply(*args, eps)
    if x.device.type == "cuda":
        return ln_geglu_ff_cuda(*args, eps)
    return ln_geglu_ff_plain(*args, eps)
