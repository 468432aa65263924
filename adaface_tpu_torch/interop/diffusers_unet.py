"""diffusers `UNet2DConditionModel` state dict -> the port's `UNetModel` state
dict (counterpart of `adaface_tpu/interop/diffusers_unet.py`).

The Arc2Face teacher ships in the diffusers layout; its architecture is the
SD v1.5 UNet's (`UNetConfig.sd_v1()`). diffusers keeps torch's tensor
layouts, so the map only renames:

  time_embedding.linear_{1,2}        -> time_embed_{0,2}
  conv_in / conv_out / conv_norm_out -> in_conv / out_conv / out_norm_{scale,bias}
  down_blocks.{i}.resnets.{j}        -> down_{i}_res_{j} (norm1/conv1/time_emb_proj/
                                        norm2/conv2/conv_shortcut)
  down_blocks.{i}.attentions.{j}     -> down_{i}_attn_{j} (norm/proj_in/proj_out/
                                        transformer_blocks.0 -> block_0)
  down_blocks.{i}.downsamplers.0     -> down_{i}_downsample
  mid_block.{resnets.0,attentions.0,resnets.1} -> mid_res_0 / mid_attn / mid_res_1
  up_blocks.{k}                      -> up_{n-1-k}_* (diffusers counts from the deepest)

`proj_in` / `proj_out` are 1x1 convs in SD v1.5 checkpoints and Linear
layers in those saved with `use_linear_projection`; a Linear's [out, in]
weight becomes the 1x1 conv's [out, in, 1, 1]. A key that nothing consumes
raises. `diffusers_unet_state_dict` is the inverse (writing a port UNet as
a diffusers file).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from adaface_tpu_torch.interop.checkpoint_io import find_weights_file, load_state_dict_file
from adaface_tpu_torch.models.unet import UNetConfig

DIFFUSERS_UNET_FILES = ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin")


def _name_pairs(cfg: UNetConfig) -> List[Tuple[str, str]]:
    """(port name, diffusers name) of every tensor of the UNet."""
    pairs: List[Tuple[str, str]] = []

    def put(dst: str, src: str, bias: bool = True):
        pairs.append((dst + ".weight", src + ".weight"))
        if bias:
            pairs.append((dst + ".bias", src + ".bias"))

    def norm(dst: str, src: str):
        pairs.extend([(dst + "_scale", src + ".weight"), (dst + "_bias", src + ".bias")])

    def resblock(dst: str, src: str, cin: int, cout: int):
        norm(dst + ".in_norm", src + ".norm1")
        put(dst + ".in_conv", src + ".conv1")
        put(dst + ".emb_proj", src + ".time_emb_proj")
        norm(dst + ".out_norm", src + ".norm2")
        put(dst + ".out_conv", src + ".conv2")
        if cin != cout:
            put(dst + ".skip", src + ".conv_shortcut")

    def spatial(dst: str, src: str):
        norm(dst + ".norm", src + ".norm")
        put(dst + ".proj_in", src + ".proj_in")
        put(dst + ".proj_out", src + ".proj_out")
        tb, blk = src + ".transformer_blocks.0", dst + ".block_0"
        for att in ("attn1", "attn2"):
            for p in ("to_q", "to_k", "to_v"):
                put(f"{blk}.{att}.{p}", f"{tb}.{att}.{p}", bias=False)
            put(f"{blk}.{att}.to_out", f"{tb}.{att}.to_out.0")
        for n in ("norm1", "norm2", "norm3"):
            put(f"{blk}.{n}", f"{tb}.{n}")
        put(blk + ".ff_in", tb + ".ff.net.0.proj")
        put(blk + ".ff_out", tb + ".ff.net.2")

    ch0, n_levels = cfg.model_channels, len(cfg.channel_mult)
    put("time_embed_0", "time_embedding.linear_1")
    put("time_embed_2", "time_embedding.linear_2")
    put("in_conv", "conv_in")
    norm("out_norm", "conv_norm_out")
    put("out_conv", "conv_out")

    ch, skip_chs = ch0, [ch0]
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = ch0 * mult
        for blk in range(cfg.num_res_blocks):
            resblock(f"down_{level}_res_{blk}", f"down_blocks.{level}.resnets.{blk}", ch, out_ch)
            if level in cfg.attention_levels:
                spatial(f"down_{level}_attn_{blk}", f"down_blocks.{level}.attentions.{blk}")
            ch = out_ch
            skip_chs.append(ch)
        if level != n_levels - 1:
            put(f"down_{level}_downsample.conv", f"down_blocks.{level}.downsamplers.0.conv")
            skip_chs.append(ch)

    resblock("mid_res_0", "mid_block.resnets.0", ch, ch)
    spatial("mid_attn", "mid_block.attentions.0")
    resblock("mid_res_1", "mid_block.resnets.1", ch, ch)

    for up_idx, level in enumerate(reversed(range(n_levels))):
        out_ch = ch0 * cfg.channel_mult[level]
        for blk in range(cfg.num_res_blocks + 1):
            resblock(f"up_{level}_res_{blk}", f"up_blocks.{up_idx}.resnets.{blk}",
                     ch + skip_chs.pop(), out_ch)
            if level in cfg.attention_levels:
                spatial(f"up_{level}_attn_{blk}", f"up_blocks.{up_idx}.attentions.{blk}")
            ch = out_ch
        if level != 0:
            put(f"up_{level}_upsample.conv", f"up_blocks.{up_idx}.upsamplers.0.conv")
    return pairs


def _is_proj(name: str) -> bool:
    return name.endswith((".proj_in.weight", ".proj_out.weight"))


def map_diffusers_unet_state_dict(sd: Dict[str, torch.Tensor], cfg: UNetConfig
                                  ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for dst, src in _name_pairs(cfg):
        t = sd[src]
        out[dst] = t[:, :, None, None] if _is_proj(dst) and t.dim() == 2 else t
    unused = sorted(set(sd) - {src for _, src in _name_pairs(cfg)})
    if unused:
        raise ValueError(f"{len(unused)} diffusers UNet keys not consumed by the map "
                         f"(architecture mismatch?): {unused[:8]}")
    return out


def diffusers_unet_state_dict(unet_sd: Dict[str, torch.Tensor], cfg: UNetConfig
                              ) -> Dict[str, torch.Tensor]:
    """The inverse map: the port's UNet state dict in the diffusers layout
    (1x1-conv projections, as SD v1.5 files hold them)."""
    return {src: unet_sd[dst] for dst, src in _name_pairs(cfg)}


def load_diffusers_unet(path: str, cfg: Optional[UNetConfig] = None) -> Dict[str, torch.Tensor]:
    """The port's UNet state dict from a diffusers weights file, or a
    directory holding `diffusion_pytorch_model.safetensors` / `.bin`."""
    sd = load_state_dict_file(find_weights_file(path, DIFFUSERS_UNET_FILES))
    return map_diffusers_unet_state_dict(sd, cfg or UNetConfig.sd_v1())
