"""SD VAE (AutoencoderKL), NHWC at the interface (counterpart of
`adaface_tpu/models/vae.py` without the fg-mask isolation of the mid
attention): `Encoder` + `quant_conv` (`encode` -> mean, logvar) and
`post_quant_conv` + `Decoder` (`decode`), GroupNorm eps 1e-6. The mid-block
attention is single-head with fp32 scores, query-chunked (512 query rows at
a time from 1024 tokens up), plain torch. Submodules carry the flax tree's
names under `encoder.` and `decoder.`."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from adaface_tpu_torch.ops.basic import conv_nhwc, group_norm
from adaface_tpu_torch.ops.subpixel import upsample_conv

SD_VAE_SCALE_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_channels: int = 3
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True

    @classmethod
    def sd_v1(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)


def _conv(cin: int, cout: int, kernel: int = 3) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, padding=kernel // 2)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1_scale = nn.Parameter(torch.empty(in_ch))
        self.norm1_bias = nn.Parameter(torch.empty(in_ch))
        self.conv1 = _conv(in_ch, out_ch)
        self.norm2_scale = nn.Parameter(torch.empty(out_ch))
        self.norm2_bias = nn.Parameter(torch.empty(out_ch))
        self.conv2 = _conv(out_ch, out_ch)
        self.nin_shortcut = _conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = F.silu(group_norm(x, self.norm1_scale, self.norm1_bias, 32, 1e-6))
        h = conv_nhwc(self.conv1, h)
        h = F.silu(group_norm(h, self.norm2_scale, self.norm2_bias, 32, 1e-6))
        h = conv_nhwc(self.conv2, h)
        if self.nin_shortcut is not None:
            x = conv_nhwc(self.nin_shortcut, x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (the unmasked path): scores from
    an fp32 product (the JAX package's `preferred_element_type`), fp32
    softmax, probabilities cast to v's dtype for the value product."""

    CHUNK = 512

    def __init__(self, ch: int):
        super().__init__()
        self.norm_scale = nn.Parameter(torch.empty(ch))
        self.norm_bias = nn.Parameter(torch.empty(ch))
        self.q = _conv(ch, ch, 1)
        self.k = _conv(ch, ch, 1)
        self.v = _conv(ch, ch, 1)
        self.proj_out = _conv(ch, ch, 1)

    def forward(self, x):
        b, hh, ww, c = x.shape
        l = hh * ww
        h = group_norm(x, self.norm_scale, self.norm_bias, 32, 1e-6)
        qf, kf, vf = (conv_nhwc(m, h).reshape(b, l, c) for m in (self.q, self.k, self.v))
        scale = c ** -0.5
        kt = kf.float().transpose(1, 2)
        if l >= 1024:
            # query-chunked: the fp32 logits slab is [B, 512, L], not [B, L, L]
            outs = []
            for s in range(0, l, self.CHUNK):
                lg = torch.matmul(qf[:, s:s + self.CHUNK].float(), kt) * scale
                outs.append(torch.matmul(torch.softmax(lg, dim=-1).to(vf.dtype), vf))
            out = torch.cat(outs, dim=1)
        else:
            probs = torch.softmax(torch.matmul(qf.float(), kt) * scale, dim=-1)
            out = torch.matmul(probs.to(vf.dtype), vf)
        return x + conv_nhwc(self.proj_out, out.reshape(b, hh, ww, c))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv(ch, ch)

    def forward(self, x):
        return upsample_conv(x, self.conv.weight, self.conv.bias)


class Downsample(nn.Module):
    """Pad right and bottom by one, then a stride-2 VALID 3x3 conv (the
    reference's (0, 1, 0, 1) pad; a symmetric pad 1 samples other pixels)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x):
        return conv_nhwc(self.conv, F.pad(x, (0, 0, 0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = _conv(cfg.in_channels, cfg.ch)
        ch = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{i}_block_{j}", ResnetBlock(ch, cfg.ch * mult))
                ch = cfg.ch * mult
            if i != len(cfg.ch_mult) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(ch))
        self.mid_block_1 = ResnetBlock(ch, ch)
        self.mid_attn_1 = AttnBlock(ch)
        self.mid_block_2 = ResnetBlock(ch, ch)
        self.norm_out_scale = nn.Parameter(torch.empty(ch))
        self.norm_out_bias = nn.Parameter(torch.empty(ch))
        self.conv_out = _conv(ch, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels)

    def forward(self, x):
        c = self.cfg
        h = conv_nhwc(self.conv_in, x)
        for i in range(len(c.ch_mult)):
            for j in range(c.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != len(c.ch_mult) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        h = F.silu(group_norm(h, self.norm_out_scale, self.norm_out_bias, 32, 1e-6))
        return conv_nhwc(self.conv_out, h)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = _conv(cfg.z_channels, block_in)
        self.mid_block_1 = ResnetBlock(block_in, block_in)
        self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in, block_in)
        ch = block_in
        for i in reversed(range(len(cfg.ch_mult))):
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}", ResnetBlock(ch, cfg.ch * cfg.ch_mult[i]))
                ch = cfg.ch * cfg.ch_mult[i]
            if i != 0:
                self.add_module(f"up_{i}_upsample", Upsample(ch))
        self.norm_out_scale = nn.Parameter(torch.empty(ch))
        self.norm_out_bias = nn.Parameter(torch.empty(ch))
        self.conv_out = _conv(ch, cfg.out_channels)

    def forward(self, z):
        c = self.cfg
        h = conv_nhwc(self.conv_in, z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for i in reversed(range(len(c.ch_mult))):
            for j in range(c.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(h)
        h = F.silu(group_norm(h, self.norm_out_scale, self.norm_out_bias, 32, 1e-6))
        return conv_nhwc(self.conv_out, h)


class AutoencoderKL(nn.Module):
    """[B, H, W, 3] images in about [-1, 1] <-> [B, h, w, embed_dim] latents."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        mul = 2 if cfg.double_z else 1
        self.quant_conv = _conv(mul * cfg.z_channels, mul * cfg.embed_dim, 1)
        self.post_quant_conv = _conv(cfg.embed_dim, cfg.z_channels, 1)

    def encode(self, x: torch.Tensor):
        """(mean, logvar), each [B, h, w, embed_dim]; logvar clamped to
        [-30, 20] as in DiagonalGaussianDistribution."""
        x = x.to(self.quant_conv.weight.dtype)
        moments = conv_nhwc(self.quant_conv, self.encoder(x))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(conv_nhwc(self.post_quant_conv, z))
