"""Attention on packed `[B, L, H*D]` tensors, the UNet's attention entry.

Counterpart of `adaface_tpu/ops/flash_attention.py:flash_attention_blc` and
`flash_attention_qkv` with the JAX package's default knobs:

- Lq < 256 or Lk < 256 (cross-attention with 77 keys, the 8x8 mid block):
  the plain einsum-softmax path (`_reference_attention` semantics: natural-log
  scores, additive bias, no floor), on any device.
- otherwise the packed flash kernel: on a CUDA tensor the hand-written Hopper
  kernel `csrc/flash_attn_packed.cu` (which replaces the TPU kernels
  `_flash_kernel_heads_pvt` and `_flash_kernel_heads_short`), on a CPU tensor
  its plain version `flash_attention_blc_plain`.

`launches` counts kernel launches (and `launches_by_shape` the same per
(B, Lq, Lk, H, D)); callers may reset them to 0 to count one run.
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

launches = 0
launches_by_shape: Dict[Tuple[int, int, int, int, int], int] = {}

_fwd = None


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, w = t.shape
    return t.reshape(b, l, heads, w // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, d = t.shape
    return t.transpose(1, 2).reshape(b, l, h * d)


def reference_attention(q, k, v, num_heads: int, key_bias=None, scale=None):
    """Einsum-softmax attention on packed tensors (the JAX package's
    `_reference_attention`): fp32 scores and softmax, probabilities cast to
    v's dtype for the value product."""
    d = q.shape[-1] // num_heads
    scale = d ** -0.5 if scale is None else scale
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)).float() * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return _merge_heads(torch.matmul(p.to(vh.dtype), vh))


def flash_attention_blc_plain(q, k, v, num_heads: int, key_bias=None,
                              scale=None) -> torch.Tensor:
    """The kernel's function in plain fp32 torch ops: log2-domain scores
    `(q.k) * scale * log2e`, plus `bias * log2e` floored at -100 when a bias
    is given, then a base-2 softmax over the keys. One batch row at a time,
    which bounds the [H, Lq, Lk] score slab. Returns fp32 [B, Lq, H*D]."""
    b, lq, inner = q.shape
    d = inner // num_heads
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, lq, inner), dtype=torch.float32, device=q.device)
    for i in range(b):
        qh, kh, vh = (t[i].float().reshape(t.shape[1], num_heads, d).transpose(0, 1)
                      for t in (q, k, v))
        s = torch.matmul(qh, kh.transpose(1, 2)) * (scale * LOG2E)
        if key_bias is not None:
            s = torch.clamp_min(s + key_bias[i].float() * LOG2E, SCORE_FLOOR)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        o = torch.matmul(p, vh) / p.sum(dim=-1, keepdim=True)
        out[i] = o.transpose(0, 1).reshape(lq, inner)
    return out


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


def _kernel_fn():
    global _fwd
    if _fwd is None:
        fn = kernels.load("flash_attn_packed").flash_attn_packed_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def flash_attention_blc_cuda(q, k, v, num_heads: int, key_bias=None,
                             scale=None) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors; raises on anything it does
    not take (dtype, head dim, strides, alignment)."""
    global launches
    b, lq, inner = q.shape
    lk = k.shape[1]
    if inner % num_heads:
        raise ValueError(f"width {inner} is not a multiple of {num_heads} heads")
    d = inner // num_heads
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for head dims "
                         f"{KERNEL_HEAD_DIMS}, not {d}")
    scale = d ** -0.5 if scale is None else scale
    if q.device.type != "cuda":
        raise ValueError(f"q is on {q.device}, not a CUDA device")
    _check_operand(q, "q", q.device, b, inner)
    _check_operand(k, "k", q.device, b, inner)
    _check_operand(v, "v", q.device, b, inner)
    if v.shape[1] != lk:
        raise ValueError(f"k has {lk} keys, v {v.shape[1]}")
    bias = None
    if key_bias is not None:
        if key_bias.device != q.device or tuple(key_bias.shape) != (b, lk):
            raise ValueError(f"key_bias must be [{b}, {lk}] on {q.device}, got "
                             f"{tuple(key_bias.shape)} on {key_bias.device}")
        bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty((b, lq, inner), dtype=q.dtype, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 b, num_heads, lq, lk, d,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                 scale * LOG2E, stream)
    if err:
        raise RuntimeError(f"flash_attn_packed_fwd failed: CUDA error {err} "
                           f"(B{b} Lq{lq} Lk{lk} H{num_heads} d{d})")
    launches += 1
    key = (b, lq, lk, num_heads, d)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return out


def flash_attention_blc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, key_bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention on packed q [B, Lq, H*D], k/v [B, Lk, H*D]; optional
    additive key bias [B, Lk]. Returns [B, Lq, H*D] in q's dtype."""
    lq, lk = q.shape[1], k.shape[1]
    if lq < MIN_KERNEL_LEN or lk < MIN_KERNEL_LEN:
        return reference_attention(q, k, v, num_heads, key_bias, scale)
    if q.device.type == "cuda":
        return flash_attention_blc_cuda(q, k, v, num_heads, key_bias, scale)
    if q.device.type != "cpu":
        raise ValueError(f"no attention path for device {q.device}")
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
