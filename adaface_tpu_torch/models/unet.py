"""SD v1.5 U-Net, NHWC at the interface (counterpart of
`adaface_tpu/models/unet.py`, with its attention arms and the knobs below).

- The context is a native [L, B, T, D] tensor (or [1, B, T, D], broadcast over
  layers); conditioned layer `layer_idx` reads context `CA_LAYER_INDEX[...]`.
  An optional separate K-context has the same shape.
- Attention routing, as `UNetCrossAttention` in JAX, read at call time:
  with `UNetConfig.use_flash_attention` (default True), no capture and a key
  length of at least `ADAFACE_FLASH_MIN_LK` (default 0), self- and
  cross-attention at Lq >= `ADAFACE_FLASH_PACKED_MIN_L` (default 256) take
  the packed entry `ops.flash_attention.flash_attention_blc` (or
  `flash_attention_qkv` on the fused projection), unless
  `ADAFACE_FLASH_PACKED=0`; every other one the `[B, H, L, D]` entry
  `flash_attention`. Which kernel those run (or the einsum path, as the
  77-key cross-attention and the 8x8 mid block do by default) is theirs to
  decide. Otherwise the module's own einsum path, where a self-attention
  key mask sets masked scores to -finfo(float32).max.
- `UNetConfig.fuse_qkv` (default False): self-attention projects q, k and v
  with one [C, 3*inner] product of the concatenated `to_q`/`to_k`/`to_v`
  weights (the state dict is unchanged).
- `cfg_dedup`: x and timesteps arrive at batch B with a [L, 2B, T, D]
  context; the stem (in_conv, the first ResBlock, the first self-attention)
  runs once at B and the stream is tiled to 2B right before the first
  cross-attention.
- `precompute_cross_kv` hoists the loop-invariant cross-attention K/V
  projections out of the sampling loop.
- Two more knobs of the JAX package, off by default and read at call time:
  `ADAFACE_GN_MAX_ELEMS` sends the GroupNorm+SiLU of every ResBlock and of
  the output norm whose slab passes its gates to the fused kernel
  (`ops.fused_norm.group_norm_silu`); `ADAFACE_FUSED_FF=1` the feed-forward
  of every transformer block that uses flash attention and does not capture
  (`ops.fused_ff`).
- Training: `img_mask` [B, H0, W0, 1] (the augmentation's valid area) is
  nearest-resized to each level (torch index semantics) and masks the keys
  of every self-attention (on the flash entries as a bias `where(mask, 0,
  -1e30)`); `capture` returns, for the layers in `DISTILL_LAYER_INDICES`,
  the cross-attention's `q`, `attn`, `attnscore` (the pre-softmax scaled
  fp32 scores), `k`, `v` and the block output `outfeat` (only
  `capture_keys` when given), computed on the einsum path.

- `UNetConfig.use_remat`: every SpatialTransformer that does not capture is
  recomputed in the backward (`torch.utils.checkpoint`, non-reentrant), as
  JAX's `nn.remat`; its flash forwards (and, under the fused knobs, its K9
  feed-forward) launch again there.

Submodules carry the flax tree's names (`down_0_res_0.in_conv`,
`down_0_attn_0.block_0.attn1.to_q`, ...). Subject-token convolutional
attention is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from adaface_tpu_torch import knobs
from adaface_tpu_torch.ops import fused_ff
from adaface_tpu_torch.ops.basic import conv_nhwc, group_norm, timestep_embedding
from adaface_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_blc,
                                                   flash_attention_qkv)
from adaface_tpu_torch.ops.fused_norm import group_norm_silu
from adaface_tpu_torch.ops.subpixel import upsample_conv

# layer_idx -> cross-attention (context) index, as in the JAX package
CA_LAYER_INDEX = {1: 0, 2: 1, 4: 2, 5: 3, 7: 4, 8: 5, 12: 6, 16: 7,
                  17: 8, 18: 9, 19: 10, 20: 11, 21: 12, 22: 13, 23: 14, 24: 15}
NUM_CA_LAYERS = 16
# layers whose activations feed the distillation losses
DISTILL_LAYER_INDICES = (7, 8, 12, 16, 17, 18, 19, 20, 21, 22, 23, 24)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_levels: tuple = (0, 1, 2)
    num_heads: int = 8
    context_dim: int = 768
    use_flash_attention: bool = True
    fuse_qkv: bool = False
    # recompute each SpatialTransformer that does not capture in the backward
    # (torch.utils.checkpoint; JAX's nn.remat); capture layers keep their
    # activations, which are the distillation losses' inputs
    use_remat: bool = False

    @classmethod
    def sd_v1(cls, **kw) -> "UNetConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "UNetConfig":
        d = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 attention_levels=(0, 1), num_heads=4, context_dim=16)
        d.update(kw)
        return cls(**d)


def _conv(cin: int, cout: int, kernel: int = 3, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)


def _nearest_resize_mask(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') indices: src = floor(dst*in/out)."""
    ih, iw = m.shape[1:3]
    ridx = torch.arange(h, device=m.device) * ih // h
    cidx = torch.arange(w, device=m.device) * iw // w
    return m[:, ridx][:, :, cidx]


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, emb_dim: int):
        super().__init__()
        self.in_norm_scale = nn.Parameter(torch.empty(in_ch))
        self.in_norm_bias = nn.Parameter(torch.empty(in_ch))
        self.in_conv = _conv(in_ch, out_ch)
        self.emb_proj = nn.Linear(emb_dim, out_ch)
        self.out_norm_scale = nn.Parameter(torch.empty(out_ch))
        self.out_norm_bias = nn.Parameter(torch.empty(out_ch))
        self.out_conv = _conv(out_ch, out_ch)
        self.skip = _conv(in_ch, out_ch, kernel=1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = group_norm_silu(x, self.in_norm_scale, self.in_norm_bias, 32, 1e-5)
        h = conv_nhwc(self.in_conv, h)
        h = h + self.emb_proj(F.silu(emb))[:, None, None, :]
        h = group_norm_silu(h, self.out_norm_scale, self.out_norm_bias, 32, 1e-5)
        h = conv_nhwc(self.out_conv, h)
        if self.skip is not None:
            x = conv_nhwc(self.skip, x)
        return x + h


class UNetCrossAttention(nn.Module):
    """Multi-head attention on packed [B, L, H*D] projections; self-attention
    when no context is given. `kv` takes hoisted (k, v) projections,
    `key_mask` [B, Lk] (True = attend) masks the keys of a self-attention.
    Returns (out, captured dict or None); `capture` takes the einsum path,
    whose scores it returns."""

    def __init__(self, dim: int, ctx_dim: int, num_heads: int, use_flash: bool = True,
                 fuse_qkv: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.fuse_qkv = fuse_qkv
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x, ctx_v=None, ctx_k=None, kv=None, key_mask=None,
                capture: bool = False):
        h = self.num_heads
        inner = self.to_q.weight.shape[0]
        d = inner // h
        qkv = None
        if ctx_v is None and self.fuse_qkv:
            # one [C, 3*inner] product; the parameters stay three nn.Linear
            w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight], dim=0)
            qkv = F.linear(x, w)
            q, k, v = qkv.split(inner, dim=-1)
        else:
            q = self.to_q(x)
            if ctx_v is None:
                ctx_v = ctx_k = x
            elif ctx_k is None:
                ctx_k = ctx_v
            k, v = kv if kv is not None else (self.to_k(ctx_k), self.to_v(ctx_v))
        b, lq, _ = q.shape
        lk = k.shape[1]
        scale = d ** -0.5
        split = lambda t: t.reshape(b, t.shape[1], h, d).transpose(1, 2)
        merge = lambda t: t.transpose(1, 2).reshape(b, lq, inner)
        if (self.use_flash and not capture
                and lk >= knobs.intval("ADAFACE_FLASH_MIN_LK", 0)):
            key_bias = (None if key_mask is None
                        else torch.where(key_mask, 0.0, -1e30).to(torch.float32))
            if (lq >= knobs.intval("ADAFACE_FLASH_PACKED_MIN_L", 256)
                    and knobs.get("ADAFACE_FLASH_PACKED") != "0"):
                if qkv is not None:
                    out = flash_attention_qkv(qkv, h, key_bias=key_bias, scale=scale)
                else:
                    out = flash_attention_blc(q, k, v, h, key_bias=key_bias, scale=scale)
            else:
                out = merge(flash_attention(split(q), split(k), split(v), key_bias=key_bias,
                                            scale=scale))
            return self.to_out(out), None
        qh, kh, vh = split(q), split(k), split(v)
        sim = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
        if key_mask is not None:
            sim = torch.where(key_mask[:, None, None, :], sim,
                              -torch.finfo(torch.float32).max)
        attn = torch.softmax(sim, dim=-1)
        out = self.to_out(merge(torch.matmul(attn.to(vh.dtype), vh)))
        if not capture:
            return out, None
        # q scaled by sqrt(scale) so q.q^T products carry the full scale
        return out, {"q": qh * scale ** 0.5, "attn": attn, "attnscore": sim, "k": kh,
                     "v": vh}


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, num_heads: int, use_flash: bool = True,
                 fuse_qkv: bool = False):
        super().__init__()
        self.use_flash = use_flash
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = UNetCrossAttention(dim, dim, num_heads, use_flash, fuse_qkv)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = UNetCrossAttention(dim, ctx_dim, num_heads, use_flash, fuse_qkv)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff_in = nn.Linear(dim, dim * 8)  # GEGLU: 2 x 4*dim
        self.ff_out = nn.Linear(dim * 4, dim)

    def forward(self, x, ctx_v, ctx_k, kv=None, cfg_tile: bool = False, key_mask=None,
                capture: bool = False):
        x = x + self.attn1(self.norm1(x), key_mask=key_mask)[0]
        if cfg_tile:
            x = torch.cat([x, x], dim=0)
        a2, aux = self.attn2(self.norm2(x), ctx_v, ctx_k, kv, capture=capture)
        x = x + a2
        # the fused feed-forward (ADAFACE_FUSED_FF=1) runs where the block uses
        # flash attention and does not capture, as in the JAX package; the
        # weights go in transposed views
        fused = self.use_flash and not capture
        ff = fused_ff.ln_geglu_ff if fused else fused_ff.ln_geglu_ff_unfused
        return ff(x, self.norm3.weight, self.norm3.bias, self.ff_in.weight.t(),
                  self.ff_in.bias, self.ff_out.weight.t(), self.ff_out.bias), aux


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, ctx_dim: int, num_heads: int, use_flash: bool = True,
                 fuse_qkv: bool = False):
        super().__init__()
        self.norm_scale = nn.Parameter(torch.empty(ch))
        self.norm_bias = nn.Parameter(torch.empty(ch))
        self.proj_in = _conv(ch, ch, kernel=1)
        self.block_0 = TransformerBlock(ch, ctx_dim, num_heads, use_flash, fuse_qkv)
        self.proj_out = _conv(ch, ch, kernel=1)

    def forward(self, x, ctx_v, ctx_k, kv=None, cfg_tile: bool = False, img_mask=None,
                capture: bool = False):
        b, hh, ww, c = x.shape
        h = group_norm(x, self.norm_scale, self.norm_bias, 32, 1e-6)
        h = conv_nhwc(self.proj_in, h).reshape(b, hh * ww, c)
        key_mask = None
        if img_mask is not None:
            key_mask = _nearest_resize_mask(img_mask, hh, ww).reshape(b, hh * ww) > 0
        h, aux = self.block_0(h, ctx_v, ctx_k, kv, cfg_tile, key_mask, capture)
        if cfg_tile:  # the block returned 2B rows; tile the residual to match
            x = torch.cat([x, x], dim=0)
        h = conv_nhwc(self.proj_out, h.reshape(x.shape[0], hh, ww, c))
        return x + h, aux


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv(ch, ch, stride=2)

    def forward(self, x):
        return conv_nhwc(self.conv, x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv(ch, ch)

    def forward(self, x):
        return upsample_conv(x, self.conv.weight, self.conv.bias)


def ca_layer_module_names(cfg: UNetConfig) -> Dict[int, str]:
    """layer_idx -> SpatialTransformer name, in the UNet's layer walk (input
    blocks, middle, output blocks; downsamples and upsamples take an index)."""
    names = {}
    layer_idx = 1
    for level in range(len(cfg.channel_mult)):
        for blk in range(cfg.num_res_blocks):
            if level in cfg.attention_levels:
                names[layer_idx] = f"down_{level}_attn_{blk}"
            layer_idx += 1
        if level != len(cfg.channel_mult) - 1:
            layer_idx += 1
    names[layer_idx] = "mid_attn"
    layer_idx += 1
    for level in reversed(range(len(cfg.channel_mult))):
        for blk in range(cfg.num_res_blocks + 1):
            if level in cfg.attention_levels:
                names[layer_idx] = f"up_{level}_attn_{blk}"
            layer_idx += 1
    return names


class UNetModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.model_channels
        emb_dim = ch0 * 4
        attn_names = ca_layer_module_names(cfg)
        by_name = {name: idx for idx, name in attn_names.items()}

        def spatial(name: str, ch: int) -> SpatialTransformer:
            # layers outside CA_LAYER_INDEX (toy configs only) run attn2 as
            # self-attention, so their K/V project from the stream itself
            mapped = by_name[name] in CA_LAYER_INDEX
            return SpatialTransformer(ch, cfg.context_dim if mapped else ch, cfg.num_heads,
                                      cfg.use_flash_attention, cfg.fuse_qkv)

        self.time_embed_0 = nn.Linear(ch0, emb_dim)
        self.time_embed_2 = nn.Linear(emb_dim, emb_dim)
        self.in_conv = _conv(cfg.in_channels, ch0)
        skip_chs = [ch0]
        ch = ch0
        for level, mult in enumerate(cfg.channel_mult):
            for blk in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_res_{blk}", ResBlock(ch, ch0 * mult, emb_dim))
                ch = ch0 * mult
                if level in cfg.attention_levels:
                    name = f"down_{level}_attn_{blk}"
                    self.add_module(name, spatial(name, ch))
                skip_chs.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.add_module(f"down_{level}_downsample", Downsample(ch))
                skip_chs.append(ch)
        self.mid_res_0 = ResBlock(ch, ch, emb_dim)
        self.mid_attn = spatial("mid_attn", ch)
        self.mid_res_1 = ResBlock(ch, ch, emb_dim)
        for level in reversed(range(len(cfg.channel_mult))):
            for blk in range(cfg.num_res_blocks + 1):
                out_ch = ch0 * cfg.channel_mult[level]
                self.add_module(f"up_{level}_res_{blk}",
                                ResBlock(ch + skip_chs.pop(), out_ch, emb_dim))
                ch = out_ch
                if level in cfg.attention_levels:
                    name = f"up_{level}_attn_{blk}"
                    self.add_module(name, spatial(name, ch))
                if level != 0 and blk == cfg.num_res_blocks:
                    self.add_module(f"up_{level}_upsample", Upsample(ch))
        self.out_norm_scale = nn.Parameter(torch.empty(ch))
        self.out_norm_bias = nn.Parameter(torch.empty(ch))
        self.out_conv = _conv(ch, cfg.out_channels)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                context_k: Optional[torch.Tensor] = None, cfg_dedup: bool = False,
                cross_kv: Optional[Tuple] = None, img_mask: Optional[torch.Tensor] = None,
                capture: bool = False, capture_keys: Optional[Tuple[str, ...]] = None):
        """x [B, H, W, C] (B = half the context batch under cfg_dedup),
        timesteps [B], context [L|1, B', T, D], img_mask [B, H0, W0, 1].
        Returns fp32 eps [B', H, W, out_channels]; with `capture`, (eps,
        {layer_idx: captured tensors})."""
        c = self.cfg
        if cfg_dedup and (capture or img_mask is not None):
            raise ValueError("cfg_dedup is inference-only (no capture or img_mask)")
        if cfg_dedup and 0 not in c.attention_levels:
            raise ValueError("cfg_dedup needs an attention block at level 0 to tile at")
        dtype = self.in_conv.weight.dtype
        emb = self.time_embed_0(timestep_embedding(timesteps, c.model_channels).to(dtype))
        emb = self.time_embed_2(F.silu(emb))
        if context.dim() == 3:
            context = context[None]
        if context_k is not None and context_k.dim() == 3:
            context_k = context_k[None]

        captures = {}

        def spatial(layer_idx: int, h: torch.Tensor, name: str) -> torch.Tensor:
            cv = ck = kv = None
            if layer_idx in CA_LAYER_INDEX:
                i = CA_LAYER_INDEX[layer_idx]
                cv = context[i % context.shape[0]]
                ck = cv if context_k is None else context_k[i % context_k.shape[0]]
                if cross_kv is not None:
                    kv = cross_kv[i]
            do_cap = capture and layer_idx in DISTILL_LAYER_INDICES
            block = getattr(self, name)
            if c.use_remat and not do_cap and torch.is_grad_enabled():
                h, aux = torch.utils.checkpoint.checkpoint(
                    block, h, cv, ck, kv, cfg_dedup and layer_idx == 1, img_mask, False,
                    use_reentrant=False)
            else:
                h, aux = block(h, cv, ck, kv, cfg_tile=cfg_dedup and layer_idx == 1,
                               img_mask=img_mask, capture=do_cap)
            if do_cap:
                aux["outfeat"] = h
                if capture_keys is not None:
                    aux = {k: v for k, v in aux.items() if k in capture_keys}
                captures[layer_idx] = aux
            return h

        h = conv_nhwc(self.in_conv, x.to(dtype))
        hs = [h]
        layer_idx = 1
        for level in range(len(c.channel_mult)):
            for blk in range(c.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{blk}")(h, emb)
                if level in c.attention_levels:
                    h = spatial(layer_idx, h, f"down_{level}_attn_{blk}")
                if cfg_dedup and layer_idx == 1:
                    # the first spatial tiled the stream to 2B; so does all
                    # that was computed at B before it
                    emb = torch.cat([emb, emb], dim=0)
                    hs = [torch.cat([e, e], dim=0) for e in hs]
                hs.append(h)
                layer_idx += 1
            if level != len(c.channel_mult) - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
                hs.append(h)
                layer_idx += 1
        h = self.mid_res_0(h, emb)
        h = spatial(layer_idx, h, "mid_attn")
        h = self.mid_res_1(h, emb)
        layer_idx += 1
        for level in reversed(range(len(c.channel_mult))):
            for blk in range(c.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=-1)
                h = getattr(self, f"up_{level}_res_{blk}")(h, emb)
                if level in c.attention_levels:
                    h = spatial(layer_idx, h, f"up_{level}_attn_{blk}")
                if level != 0 and blk == c.num_res_blocks:
                    h = getattr(self, f"up_{level}_upsample")(h)
                layer_idx += 1
        h = group_norm_silu(h, self.out_norm_scale, self.out_norm_bias, 32, 1e-5)
        eps = conv_nhwc(self.out_conv, h).float()
        return (eps, captures) if capture else eps


def precompute_cross_kv(unet: UNetModel, context: torch.Tensor,
                        context_k: Optional[torch.Tensor] = None) -> tuple:
    """The cross-attention K/V projections of every conditioned layer, once:
    entry CA_LAYER_INDEX[layer_idx] is (k, v), each [B, T, inner]; None for
    an index with no attention block."""
    if context.dim() == 3:
        context = context[None]
    if context_k is not None and context_k.dim() == 3:
        context_k = context_k[None]
    dtype = unet.in_conv.weight.dtype
    out = [None] * NUM_CA_LAYERS
    for layer_idx, name in ca_layer_module_names(unet.cfg).items():
        if layer_idx not in CA_LAYER_INDEX:
            continue
        i = CA_LAYER_INDEX[layer_idx]
        cv = context[i % context.shape[0]]
        ck = cv if context_k is None else context_k[i % context_k.shape[0]]
        att = getattr(unet, name).block_0.attn2
        out[i] = (att.to_k(ck.to(dtype)), att.to_v(cv.to(dtype)))
    return tuple(out)
