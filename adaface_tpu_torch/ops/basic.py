"""Elementwise and normalization building blocks (counterpart of
`adaface_tpu/ops/basic.py`). Statistics are fp32 whatever the input dtype;
outputs come back in the input dtype."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from adaface_tpu_torch import knobs


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings [B, dim] in [cos, sin] order."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over the channel (last) axis of an N...C tensor, as the JAX
    package computes it: per-channel fp32 sums of x and x^2 over the spatial
    axes, grouped, one-pass variance E[x^2] - mean^2 clamped at 0, then one
    per-(batch, channel) affine. eps is 1e-5 in UNet ResBlocks and the UNet
    output norm, 1e-6 in SpatialTransformer and the VAE.

    Under `ADAFACE_GN_SHIFT=1` (read at call time) the sums are taken of x
    minus a per-group probe, the group mean of the first spatial position
    (detached, so gradients are those of the unshifted formula), and the
    probe is added back to the mean: the one-pass variance then survives a
    large common-mode offset that the raw form loses to fp32 cancellation."""
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    red = tuple(range(1, x.dim() - 1))
    n = x[0].numel() // c * (c // g)
    xf = x.float()
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    if knobs.get("ADAFACE_GN_SHIFT") == "1":
        shift = xf.reshape(b, -1, c)[:, 0].detach().view(b, g, c // g).mean(-1)
        xsh = xf - shift.repeat_interleave(c // g, dim=1).view(shape)
    else:
        shift, xsh = 0.0, xf
    s1 = xsh.sum(dim=red).view(b, g, c // g).sum(-1)
    s2 = (xsh * xsh).sum(dim=red).view(b, g, c // g).sum(-1)
    mean_sh = s1 / n
    var = torch.clamp_min(s2 / n - mean_sh * mean_sh, 0.0)
    mean = mean_sh + shift
    rstd = torch.rsqrt(var + eps)
    sc = rstd.repeat_interleave(c // g, dim=1) * scale.float()[None]
    bi = bias.float()[None] - mean.repeat_interleave(c // g, dim=1) * sc
    return (xf * sc.view(shape) + bi.view(shape)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; torch computes the statistics in fp32
    for bf16 inputs as well."""
    cast = lambda p: None if p is None else p.to(x.dtype)
    return F.layer_norm(x, x.shape[-1:], cast(scale), cast(bias), eps)


def conv_nhwc(conv: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply a torch conv to an NHWC tensor. The permutes are views: a
    contiguous NHWC tensor is an NCHW tensor in channels_last memory, which
    is the layout cuDNN runs bf16 convolutions in."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's quick-GELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def geglu(x: torch.Tensor) -> torch.Tensor:
    """GEGLU gate of the UNet feed-forward: last dim 2d -> d, a * gelu(g),
    with the tanh-approximate GELU (jax.nn.gelu's default)."""
    a, g = x.chunk(2, dim=-1)
    return a * F.gelu(g, approximate="tanh")


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] fp32 weights of `jax.image.resize`'s bilinear
    (triangle) kernel with antialias: sample position (i + 0.5) * in/out -
    0.5, kernel widened by in/out when shrinking, each column renormalized
    to sum 1, columns sampled outside the input zeroed."""
    inv_scale = np.float32(n_in / n_out)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_aa(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """[..., H, W] -> [..., oh, ow] as `jax.image.resize(..., "bilinear")`
    on those two axes (antialiased when shrinking), in fp32."""
    h, w = x.shape[-2:]
    x = x.float()
    if (h, w) == (oh, ow):
        return x
    wh = torch.from_numpy(_resize_weights(h, oh)).to(x.device)
    ww = torch.from_numpy(_resize_weights(w, ow)).to(x.device)
    return torch.einsum("...hw,hy,wx->...yx", x, wh, ww)
