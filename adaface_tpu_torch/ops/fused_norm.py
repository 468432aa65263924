"""Fused GroupNorm(+affine)+SiLU over the channel (last) axis of an N...C
tensor (counterpart of `adaface_tpu/ops/fused_norm.py`).

`group_norm_silu` keeps the JAX function's gates exactly: a slab that fails
one (channels not a multiple of the groups, `N * C` above
`ADAFACE_GN_MAX_ELEMS`, fewer than 3 dims, `N` not a multiple of 8) takes
`_plain`, the port's `ops.basic.group_norm` cast to x's dtype and then SiLU,
which is what the UNet's ResBlocks computed before the knob existed. The
threshold is read at call time (the JAX package reads it once, at import);
its default 0 sends every site to `_plain`.

A slab that passes the gates goes to the kernel's function: on a CUDA tensor
the hand-written Hopper kernel `csrc/gn_silu.cu` (which replaces the TPU
kernel `_gn_silu_kernel`; its bf16 instance for bf16 x, its fp32 instance,
with fp32 scale and bias, for an fp32 pipeline), on a CPU tensor its plain
version `group_norm_silu_plain`. That function applies SiLU in fp32 before the cast,
so on bf16 inputs it differs from `_plain` by one rounding. Its gradient,
`GroupNormSiLU`, recomputes through `_plain` and differentiates it, as the
JAX package's `_fused_bwd` does; there is no backward kernel.

The kernel gives each image one thread-block cluster (`launch_plan`): its
CTAs sum their rows, add the cluster's per-group partial sums in rank order
(`cluster_partials` and `group_norm_silu_from_partials` are that summation
tree in plain ops), then read their rows again to normalise them.

`launches_by_shape` counts kernel calls (one launch each) per (dtype, B, N,
C), dtype "bf16" or "fp32"; callers may clear it to count one run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from adaface_tpu_torch import kernels, knobs
from adaface_tpu_torch.device import sm_count
from adaface_tpu_torch.ops.basic import group_norm
from adaface_tpu_torch.ops.grad import recompute_grads

# The kernel's limits (csrc/gn_silu.cu).
MAX_CLUSTER = 16  # CTAs an image (a non-portable cluster size above 8)
MAX_THREADS = 512  # a CTA of row lanes, C <= 4096
WIDE_THREADS = 1024  # a CTA of one row lane, C <= 8192
# launch_plan: the grid fills the card when it has a CTA for this share of
# the SMs; where it does, a CTA streams at most this much of its image.
FILL = 0.85
CTA_BYTES = 192 * 1024

launches_by_shape: Dict[Tuple[str, int, int, int], int] = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> (library, argument types), as declared in csrc/<library>.cu
C_ENTRIES = {name: ("gn_silu", [_P] * 4 + [_I] * 6 + [_F, _I, _P])
             for name in ("gn_silu_fwd", "gn_silu_fwd_fp32")}
# x's dtype -> (the kernel instance's C entry, its label in launches_by_shape)
KERNEL_DTYPES = {torch.bfloat16: ("gn_silu_fwd", "bf16"),
                 torch.float32: ("gn_silu_fwd_fp32", "fp32")}


class LaunchPlan(NamedTuple):
    cluster: int  # CTAs an image, one thread-block cluster; grid (cluster, B)
    threads: int  # a CTA: row lanes x C/8 columns of 8 channels


def cta_rows(n: int, cluster: int, rank: int) -> Tuple[int, int]:
    """Rows [r0, r1) of an image of N rows that CTA `rank` of its cluster
    owns."""
    return rank * n // cluster, (rank + 1) * n // cluster


@functools.lru_cache(maxsize=None)  # a pure function of ints, asked once a call
def launch_plan(b: int, n: int, c: int, sms: int, itemsize: int = 2) -> LaunchPlan:
    """K8's launch for B images of N rows x C channels of `itemsize` bytes
    (2 bf16, 4 fp32) on a card of `sms` SMs. The cluster is a power of two,
    at most MAX_CLUSTER and at most N: the smallest whose grid (cluster x B
    CTAs) fills the card (FILL) while each CTA streams at most CTA_BYTES of
    its image, else the largest, so
    that the most CTAs stream at once. Threads: C/8 columns x the row lanes
    that come nearest 256 where the grid fills the card, else 512 (the
    batch-3 training shapes: 48 CTAs), at most MAX_THREADS; one row lane
    where C/8 is wider than that."""
    sizes = [s for s in (1, 2, 4, 8, MAX_CLUSTER) if s <= max(1, n)]
    fills = lambda s: b * s >= FILL * sms
    fits = [s for s in sizes if fills(s) and itemsize * c * -(-n // s) <= CTA_BYTES]
    cluster = fits[0] if fits else sizes[-1]
    target = 256 if fills(cluster) else MAX_THREADS
    cv = c // 8
    lanes = max(1, min(round(target / cv), MAX_THREADS // cv))
    return LaunchPlan(cluster, lanes * cv)


def _plain(x, scale, bias, num_groups, eps, apply_silu):
    out = group_norm(x, scale, bias, num_groups=num_groups, eps=eps)
    return F.silu(out) if apply_silu else out


def group_norm_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          num_groups: int = 32, eps: float = 1e-5,
                          apply_silu: bool = True) -> torch.Tensor:
    """The kernel's function (`_gn_silu_kernel`) in plain torch ops, in fp32
    (fp64 for fp64 inputs): per-group sums of x and x^2 over the image,
    mean = s / count, var = max(E[x^2] - mean^2, 0), sc = scale *
    rsqrt(var + eps), sh = bias - mean * sc, out = x * sc + sh, SiLU, then
    one cast to x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    cdt = torch.promote_types(x.dtype, torch.float32)
    xf = x.reshape(b, -1, c).to(cdt)
    cg = c // num_groups
    inv_count = 1.0 / (xf.shape[1] * cg)
    s = xf.sum(dim=1).view(b, num_groups, cg).sum(-1)
    ss = (xf * xf).sum(dim=1).view(b, num_groups, cg).sum(-1)
    mean = s * inv_count
    var = torch.clamp_min(ss * inv_count - mean * mean, 0.0)
    sc = scale.to(cdt)[None] * torch.rsqrt(var + eps).repeat_interleave(cg, dim=1)
    sh = bias.to(cdt)[None] - mean.repeat_interleave(cg, dim=1) * sc
    out = xf * sc[:, None] + sh[:, None]
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype).reshape(x.shape)


def cluster_partials(x: torch.Tensor, cluster: int, num_groups: int = 32) -> torch.Tensor:
    """Each CTA's partial sums [B, cluster, 2, G] of x and x^2 per group over
    its rows (`cta_rows`), in fp32 (fp64 for fp64 inputs): the kernel's
    first level of sums, in plain torch ops."""
    b, c = x.shape[0], x.shape[-1]
    cdt = torch.promote_types(x.dtype, torch.float32)
    xf = x.reshape(b, -1, c).to(cdt)
    n = xf.shape[1]
    parts = []
    for rank in range(cluster):
        r0, r1 = cta_rows(n, cluster, rank)
        part = xf[:, r0:r1]
        parts.append(torch.stack([part.sum(1), (part * part).sum(1)], 1)
                     .view(b, 2, num_groups, c // num_groups).sum(-1))
    return torch.stack(parts, 1)


def group_norm_silu_from_partials(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                  parts: torch.Tensor, eps: float = 1e-5,
                                  apply_silu: bool = True) -> torch.Tensor:
    """The kernel's function from its CTAs' partials (`cluster_partials`),
    added in rank order as every CTA of the cluster adds them, in plain
    torch ops; then as `group_norm_silu_plain`."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.reshape(b, -1, c).to(parts.dtype)
    groups = parts.shape[-1]
    cg = c // groups
    tot = parts[:, 0]
    for k in range(1, parts.shape[1]):
        tot = tot + parts[:, k]
    inv_count = 1.0 / (xf.shape[1] * cg)
    mean = tot[:, 0] * inv_count
    var = torch.clamp_min(tot[:, 1] * inv_count - mean * mean, 0.0)
    sc = scale.to(xf.dtype)[None] * torch.rsqrt(var + eps).repeat_interleave(cg, dim=1)
    sh = bias.to(xf.dtype)[None] - mean.repeat_interleave(cg, dim=1) * sc
    out = xf * sc[:, None] + sh[:, None]
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype).reshape(x.shape)


def _fn(name: str):
    """The ctypes entry `name` of its library, with its signature set."""
    return kernels.entry(name, *C_ENTRIES[name])


def _as_vector(t: torch.Tensor, c: int, name: str, device, dtype) -> torch.Tensor:
    """t as the kernel reads it: `dtype` (x's), contiguous, 16-byte aligned;
    t itself (no copy) when it is already."""
    if t.shape != (c,) or t.device != device:
        raise ValueError(f"{name} must be [{c}] on {device}, got {tuple(t.shape)} "
                         f"on {t.device}")
    if t.dtype == dtype and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return torch.empty(c, dtype=dtype, device=device).copy_(t.detach())


def group_norm_silu_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         num_groups: int = 32, eps: float = 1e-5,
                         apply_silu: bool = True) -> torch.Tensor:
    """Launch the Hopper kernel on a CUDA tensor [B, ..., C], its bf16
    instance for bf16 x and its fp32 instance (scale and bias in fp32) for
    fp32 x, with `launch_plan`'s launch; raises on anything it does not
    take."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernel takes bfloat16 or float32, x is {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}, not a CUDA device")
    entry, tag = KERNEL_DTYPES[x.dtype]
    b, c = x.shape[0], x.shape[-1]
    n = x.numel() // (b * c) if b and c else 0
    if c % num_groups or c % 8 or n == 0 or c > 8 * WIDE_THREADS:
        raise ValueError(f"the kernel needs C a multiple of {num_groups} groups and of "
                         f"8, at most {8 * WIDE_THREADS}, and a non-empty image; got "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"x must start 16-byte aligned, got {x.data_ptr():#x}")
    scale = _as_vector(scale, c, "scale", x.device, x.dtype)
    bias = _as_vector(bias, c, "bias", x.device, x.dtype)
    plan = launch_plan(b, n, c, sm_count(x.device.index), x.element_size())
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fn(entry)(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, n,
                         c, num_groups, plan.cluster, plan.threads, eps, int(apply_silu),
                         torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err} (B, N, C = {b}, {n}, {c}; "
                           f"{plan})")
    key = (tag, b, n, c)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return out


class GroupNormSiLU(torch.autograd.Function):
    """The kernel (CUDA) or its plain version (CPU) forward; the backward
    recomputes `_plain` on the saved inputs and differentiates it."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, eps: float, apply_silu: bool):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, apply_silu)
        if x.device.type == "cuda":
            return group_norm_silu_cuda(x, scale, bias, num_groups, eps, apply_silu)
        return group_norm_silu_plain(x, scale, bias, num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(lambda x, s, b: _plain(x, s, b, *ctx.args), ctx.saved_tensors,
                               ctx.needs_input_grad[:3], g) + (None, None, None)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm(+SiLU) over the channel (last) axis of an N...C tensor: the
    fused kernel where the JAX package's gates pass, else `_plain`."""
    c = x.shape[-1]
    n = 1
    for d in x.shape[1:-1]:
        n *= d
    if (c % num_groups or n * c > knobs.intval("ADAFACE_GN_MAX_ELEMS", 0) or x.dim() < 3
            or n % 8):
        return _plain(x, scale, bias, num_groups, eps, apply_silu)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no group_norm_silu path for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)
    if x.device.type == "cuda":
        return group_norm_silu_cuda(x, scale, bias, num_groups, eps, apply_silu)
    return group_norm_silu_plain(x, scale, bias, num_groups, eps, apply_silu)
