"""Attention on packed `[B, L, H*D]` tensors, the UNet's attention entry.

Counterpart of `adaface_tpu/ops/flash_attention.py:flash_attention_blc` and
`flash_attention_qkv` with the JAX package's default knobs:

- Lq < 256 or Lk < 256 (cross-attention with 77 keys, the 8x8 mid block):
  the plain einsum-softmax path (`_reference_attention` semantics: fp32
  scores, natural-log softmax, additive bias, no floor), on any device,
  differentiated by autograd.
- otherwise the packed flash kernels: on a CUDA tensor the hand-written
  Hopper kernels, `csrc/flash_attn_packed.cu` forward (which replaces the TPU
  kernels `_flash_kernel_heads_pvt` and `_flash_kernel_heads_short`, and
  writes the row log2-sum-exp of `_row_lse_kernel` when a gradient is
  needed) and `csrc/flash_attn_bwd.cu` (`_bwd_dq_kernel`, `_bwd_dkv_kernel`);
  on a CPU tensor their plain versions `flash_attention_blc_plain`,
  `row_lse_plain` and `flash_backward_plain`. The gradient is a
  `torch.autograd.Function`, `FlashAttentionBLC`, taken only when autograd
  records (inference launches the forward alone, with no lse).

`launches_by_shape` counts kernel launches per (kind, B, Lq, Lk, H, D), kind
one of "fwd", "dq" and "dkv"; callers may clear it to count one run.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from adaface_tpu_torch import kernels

LOG2E = 1.4426950408889634
# Floor on biased log2-domain scores (the TPU kernels' _SCORE_FLOOR): a fully
# masked key row (bias -1e30 everywhere) comes out uniform instead of 0/0.
SCORE_FLOOR = -100.0
MIN_KERNEL_LEN = 256
KERNEL_HEAD_DIMS = (40, 80, 160)

launches_by_shape: Dict[Tuple[str, int, int, int, int, int], int] = {}

_fns: Dict[str, object] = {}


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, w = t.shape
    return t.reshape(b, l, heads, w // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, d = t.shape
    return t.transpose(1, 2).reshape(b, l, h * d)


def reference_attention(q, k, v, num_heads: int, key_bias=None, scale=None):
    """Einsum-softmax attention on packed tensors (the JAX package's
    `_reference_attention`): scores from an fp32 product of the inputs (as
    JAX's `preferred_element_type=float32`), fp32 softmax, probabilities cast
    to v's dtype for the value product."""
    d = q.shape[-1] // num_heads
    scale = d ** -0.5 if scale is None else scale
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return _merge_heads(torch.matmul(p.to(vh.dtype), vh))


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
                              scale=None) -> torch.Tensor:
    """The forward kernel's function in plain torch ops (fp32, or fp64 for
    fp64 inputs): the log2-domain scores of `_log2_scores`, then a base-2
    softmax over the keys. One batch row at a time, which bounds the
    [H, Lq, Lk] score slab. Returns [B, Lq, H*D] in the compute dtype."""
    b, lq, inner = q.shape
    scale = (inner // num_heads) ** -0.5 if scale is None else scale
    cdt = _compute_dtype(q)
    out = torch.empty((b, lq, inner), dtype=cdt, device=q.device)
    for i in range(b):
        s = _log2_scores(_heads(q, i, num_heads, cdt), _heads(k, i, num_heads, cdt),
                         None if key_bias is None else key_bias[i], scale)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        o = torch.matmul(p, _heads(v, i, num_heads, cdt)) / p.sum(dim=-1, keepdim=True)
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


# ------------------------------------------------------------- CUDA wrappers
def _check_operand(t: torch.Tensor, name: str, device, b: int, inner: int):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bfloat16, {name} is {t.dtype}")
    if t.dim() != 3 or t.shape[0] != b or t.shape[2] != inner:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want [{b}, L, {inner}]")
    if (t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8
            or t.data_ptr() % 16):
        raise ValueError(f"{name} needs unit column stride, batch and row strides "
                         f"that are multiples of 8 and a 16-byte aligned start; got "
                         f"strides {t.stride()} at {t.data_ptr():#x}")


def _fn(name: str):
    """The ctypes entry `name` of its library, with its signature set."""
    fn = _fns.get(name)
    if fn is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        if name == "flash_attn_packed_fwd":
            fn = kernels.load("flash_attn_packed").flash_attn_packed_fwd
            fn.argtypes = [p] * 6 + [i] * 5 + [ll] * 8 + [f, p]
        elif name == "flash_attn_bwd_dq":
            fn = kernels.load("flash_attn_bwd").flash_attn_bwd_dq
            fn.argtypes = [p] * 8 + [i] * 5 + [p, f, f, p]
        else:
            fn = kernels.load("flash_attn_bwd").flash_attn_bwd_dkv
            fn.argtypes = [p] * 10 + [i] * 5 + [p, f, f, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


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
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, name, q.device, b, inner)
    if v.shape[1] != lk:
        raise ValueError(f"k has {lk} keys, v {v.shape[1]}")
    bias = None
    if key_bias is not None:
        if key_bias.device != q.device or tuple(key_bias.shape) != (b, lk):
            raise ValueError(f"key_bias must be [{b}, {lk}] on {q.device}, got "
                             f"{tuple(key_bias.shape)} on {key_bias.device}")
        bias = key_bias.detach().to(torch.float32).contiguous()
    return b, lq, lk, d, bias


def _count(kind: str, key: tuple):
    k = (kind,) + key
    launches_by_shape[k] = launches_by_shape.get(k, 0) + 1


def _raise_if(err: int, what: str, key: tuple):
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err} (B, Lq, Lk, H, d = {key})")


def flash_attention_blc_cuda(q, k, v, num_heads: int, key_bias=None, scale=None,
                             return_lse: bool = False):
    """Launch the forward Hopper kernel on CUDA tensors; raises on anything
    it does not take (dtype, head dim, strides, alignment). With
    `return_lse`, returns (out, lse2 [B, H, Lq] fp32)."""
    b, lq, lk, d, bias = _check_call(q, k, v, num_heads, key_bias)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, lq, num_heads * d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, num_heads, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    key = (b, lq, lk, num_heads, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attn_packed_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, num_heads, lq, lk, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            scale * LOG2E, stream)
    _raise_if(err, "flash_attn_packed_fwd", key)
    _count("fwd", key)
    return (out, lse) if return_lse else out


def _check_backward(q, k, v, key_bias, do, lse, delta, num_heads, scale):
    b, lq, lk, d, bias = _check_call(q, k, v, num_heads, key_bias)
    _check_operand(do, "dO", q.device, b, num_heads * d)
    for t, name in ((lse, "lse"), (delta, "delta")):
        if (tuple(t.shape) != (b, num_heads, lq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 [{b}, {num_heads}, {lq}] "
                             f"on {q.device}")
    return b, lq, lk, d, bias, (d ** -0.5 if scale is None else scale)


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
    """Launch the dq kernel on CUDA tensors; returns dq bf16 packed."""
    b, lq, lk, d, bias, scale = _check_backward(q, k, v, key_bias, do, lse, delta,
                                                num_heads, scale)
    dq = torch.empty((b, lq, num_heads * d), dtype=q.dtype, device=q.device)
    st = _strides(q, k, v, do, dq)
    key = (b, lq, lk, num_heads, d)
    with torch.cuda.device(q.device):
        err = _fn("flash_attn_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if bias is None else bias.data_ptr(), dq.data_ptr(),
            b, num_heads, lq, lk, d, ctypes.addressof(st), scale * LOG2E, scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, "flash_attn_bwd_dq", key)
    _count("dq", key)
    return dq


def flash_bwd_dkv_cuda(q, k, v, key_bias, do, lse, delta, num_heads: int, scale=None,
                       need_dbias: bool = False):
    """Launch the dk/dv kernel on CUDA tensors; returns (dk, dv) bf16 packed
    and, with `need_dbias`, the per-head dbias [B, H, Lk] fp32 (else None)."""
    b, lq, lk, d, bias, scale = _check_backward(q, k, v, key_bias, do, lse, delta,
                                                num_heads, scale)
    dk = torch.empty((b, lk, num_heads * d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dbias = (torch.empty((b, num_heads, lk), dtype=torch.float32, device=q.device)
             if need_dbias else None)
    st = _strides(q, k, v, do, dk, dv)
    key = (b, lq, lk, num_heads, d)
    with torch.cuda.device(q.device):
        err = _fn("flash_attn_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if bias is None else bias.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if dbias is None else dbias.data_ptr(),
            b, num_heads, lq, lk, d, ctypes.addressof(st), scale * LOG2E, scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, "flash_attn_bwd_dkv", key)
    _count("dkv", key)
    return dk, dv, dbias


def flash_backward_cuda(q, k, v, key_bias, o, do, lse, num_heads: int, scale=None,
                        need_dbias: bool = False):
    """delta from the saved bf16 o, then the dq and dk/dv kernels. Returns
    (dq, dk, dv, dbias per head or None)."""
    _check_operand(o, "o", q.device, q.shape[0], q.shape[2])
    delta = row_delta(o, do, num_heads)
    dq = flash_bwd_dq_cuda(q, k, v, key_bias, do, lse, delta, num_heads, scale)
    dk, dv, dbias = flash_bwd_dkv_cuda(q, k, v, key_bias, do, lse, delta, num_heads, scale,
                                       need_dbias)
    return dq, dk, dv, dbias


# ------------------------------------------------------------------ autograd
class FlashAttentionBLC(torch.autograd.Function):
    """Packed flash attention with the flash backward: the CUDA kernels on a
    CUDA tensor, their plain versions on a CPU tensor. Saves q, k, v, bias,
    o and the row lse; dbias is returned only when the bias needs a
    gradient (summed over heads, as `_flash_core_blc3_bwd` does)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, num_heads: int, scale: float):
        if q.device.type == "cuda":
            out, lse = flash_attention_blc_cuda(q, k, v, num_heads, key_bias, scale,
                                                return_lse=True)
        else:
            out = flash_attention_blc_plain(q, k, v, num_heads, key_bias, scale).to(q.dtype)
            lse = row_lse_plain(q, k, num_heads, key_bias, scale)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        need_db = key_bias is not None and ctx.needs_input_grad[3]
        if q.device.type == "cuda":
            dq, dk, dv, db = flash_backward_cuda(q, k, v, key_bias, out, do.contiguous(),
                                                 lse, ctx.num_heads, ctx.scale,
                                                 need_dbias=need_db)
        else:
            dq, dk, dv, db = flash_backward_plain(q, k, v, key_bias, out, do, lse,
                                                  ctx.num_heads, ctx.scale)
            dq, dk, dv = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
        dbias = db.sum(dim=1).to(key_bias.dtype) if need_db else None
        return dq, dk, dv, dbias, None, None


def flash_attention_blc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, key_bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention on packed q [B, Lq, H*D], k/v [B, Lk, H*D]; optional
    additive key bias [B, Lk]. Returns [B, Lq, H*D] in q's dtype."""
    lq, lk = q.shape[1], k.shape[1]
    if lq < MIN_KERNEL_LEN or lk < MIN_KERNEL_LEN:
        return reference_attention(q, k, v, num_heads, key_bias, scale)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no attention path for device {q.device}")
    scale = (q.shape[-1] // num_heads) ** -0.5 if scale is None else scale
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, key_bias))
    if needs_grad:
        return FlashAttentionBLC.apply(q, k, v, key_bias, num_heads, scale)
    if q.device.type == "cuda":
        return flash_attention_blc_cuda(q, k, v, num_heads, key_bias, scale)
    return flash_attention_blc_plain(q, k, v, num_heads, key_bias, scale).to(q.dtype)


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int,
                        key_bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention on a fused [B, L, 3*H*D] projection (q | k | v along
    the last axis); the thirds go to the kernel as strided views."""
    inner = qkv.shape[-1] // 3
    return flash_attention_blc(qkv[..., :inner], qkv[..., inner:2 * inner],
                               qkv[..., 2 * inner:], num_heads,
                               key_bias=key_bias, scale=scale)
