"""SD v1.x (CompVis LDM) UNet names -> the port's `UNetModel` state dict
(counterpart of `map_unet_params` in `adaface_tpu/interop/sd_unet.py`).

An SD `.ckpt` holds the UNet under `model.diffusion_model.`. LDM and the
port both keep torch's layouts (OIHW convs, [out, in] linears, 1x1-conv
`proj_in` / `proj_out`), so the map only renames:

  time_embed.{0,2}                    -> time_embed_{0,2}
  input_blocks.0.0 / out.0 / out.2    -> in_conv / out_norm_{scale,bias} / out_conv
  input_blocks.{n}.0                  -> down_{level}_res_{blk} (in_layers.{0,2},
                                         emb_layers.1, out_layers.{0,3}, skip_connection)
  input_blocks.{n}.1                  -> down_{level}_attn_{blk} (norm, proj_in,
                                         proj_out, transformer_blocks.0 -> block_0)
  input_blocks.{n}.0.op               -> down_{level}_downsample.conv
  middle_block.{0,1,2}                -> mid_res_0 / mid_attn / mid_res_1
  output_blocks.{n}.{0,1,2}           -> up_{level}_res_{blk} / up_{level}_attn_{blk} /
                                         up_{level}_upsample (`.conv`), from the deepest level

The map is strict: every key under the prefix is consumed and every
parameter filled, else it raises. `ldm_unet_state_dict` is the inverse.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from adaface_tpu_torch.models.unet import UNetConfig

UNET_PREFIX = "model.diffusion_model."


def _name_pairs(cfg: UNetConfig) -> List[Tuple[str, str]]:
    """(port name, LDM name without the prefix) of every UNet tensor."""
    pairs: List[Tuple[str, str]] = []

    def put(dst: str, src: str, bias: bool = True):
        pairs.append((dst + ".weight", src + ".weight"))
        if bias:
            pairs.append((dst + ".bias", src + ".bias"))

    def norm(dst: str, src: str):
        pairs.extend([(dst + "_scale", src + ".weight"), (dst + "_bias", src + ".bias")])

    def resblock(dst: str, src: str, cin: int, cout: int):
        norm(dst + ".in_norm", src + ".in_layers.0")
        put(dst + ".in_conv", src + ".in_layers.2")
        put(dst + ".emb_proj", src + ".emb_layers.1")
        norm(dst + ".out_norm", src + ".out_layers.0")
        put(dst + ".out_conv", src + ".out_layers.3")
        if cin != cout:
            put(dst + ".skip", src + ".skip_connection")

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
    put("time_embed_0", "time_embed.0")
    put("time_embed_2", "time_embed.2")
    put("in_conv", "input_blocks.0.0")
    norm("out_norm", "out.0")
    put("out_conv", "out.2")

    n, ch, skip_chs = 1, ch0, [ch0]
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = ch0 * mult
        for blk in range(cfg.num_res_blocks):
            resblock(f"down_{level}_res_{blk}", f"input_blocks.{n}.0", ch, out_ch)
            if level in cfg.attention_levels:
                spatial(f"down_{level}_attn_{blk}", f"input_blocks.{n}.1")
            ch = out_ch
            skip_chs.append(ch)
            n += 1
        if level != n_levels - 1:
            put(f"down_{level}_downsample.conv", f"input_blocks.{n}.0.op")
            skip_chs.append(ch)
            n += 1

    resblock("mid_res_0", "middle_block.0", ch, ch)
    spatial("mid_attn", "middle_block.1")
    resblock("mid_res_1", "middle_block.2", ch, ch)

    n = 0
    for level in reversed(range(n_levels)):
        out_ch = ch0 * cfg.channel_mult[level]
        for blk in range(cfg.num_res_blocks + 1):
            resblock(f"up_{level}_res_{blk}", f"output_blocks.{n}.0", ch + skip_chs.pop(),
                     out_ch)
            sub = 1
            if level in cfg.attention_levels:
                spatial(f"up_{level}_attn_{blk}", f"output_blocks.{n}.{sub}")
                sub += 1
            if level != 0 and blk == cfg.num_res_blocks:
                put(f"up_{level}_upsample.conv", f"output_blocks.{n}.{sub}.conv")
            ch = out_ch
            n += 1
    return pairs


def strict_map(sd: Dict[str, torch.Tensor], pairs, prefix: str, what: str
               ) -> Dict[str, torch.Tensor]:
    """{port name: sd[prefix + LDM name]} over `pairs`; raises if a pair's
    key is missing or a key under `prefix` is left over."""
    missing = [prefix + src for _, src in pairs if prefix + src not in sd]
    if missing:
        raise KeyError(f"{len(missing)} {what} keys missing from the checkpoint: {missing[:8]}")
    used = {prefix + src for _, src in pairs}
    unused = sorted(k for k in sd if k.startswith(prefix) and k not in used)
    if unused:
        raise ValueError(f"{len(unused)} {what} keys not consumed by the map "
                         f"(architecture mismatch?): {unused[:8]}")
    return {dst: sd[prefix + src] for dst, src in pairs}


def map_unet_state_dict(sd: Dict[str, torch.Tensor], cfg: UNetConfig,
                        prefix: str = UNET_PREFIX) -> Dict[str, torch.Tensor]:
    return strict_map(sd, _name_pairs(cfg), prefix, "UNet")


def ldm_unet_state_dict(unet_sd: Dict[str, torch.Tensor], cfg: UNetConfig,
                        prefix: str = UNET_PREFIX) -> Dict[str, torch.Tensor]:
    """The inverse map: the port's UNet state dict in LDM names."""
    return {prefix + src: unet_sd[dst] for dst, src in _name_pairs(cfg)}
