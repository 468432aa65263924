"""SD v1.x (CompVis LDM) AutoencoderKL names -> the port's `AutoencoderKL`
state dict (counterpart of `map_vae_params` in
`adaface_tpu/interop/sd_vae.py`).

An SD `.ckpt` holds the VAE under `first_stage_model.`; a standalone VAE
file has no prefix. Both sides keep torch's layouts, so the map renames:
`encoder.down.{i}.block.{j}` -> `encoder.down_{i}_block_{j}`,
`encoder.down.{i}.downsample` -> `encoder.down_{i}_downsample`,
`decoder.up.{i}.block.{j}` / `.upsample` -> `decoder.up_{i}_block_{j}` /
`decoder.up_{i}_upsample`, `{encoder,decoder}.mid.{block_1,attn_1,block_2}`
-> `mid_{block_1,attn_1,block_2}`, GroupNorm `norm*.weight/.bias` ->
`norm*_scale/_bias`. Strict, as `sd_unet`; `ldm_vae_state_dict` is the
inverse.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from adaface_tpu_torch.interop.sd_unet import strict_map
from adaface_tpu_torch.models.vae import VAEConfig

VAE_PREFIX = "first_stage_model."


def _name_pairs(cfg: VAEConfig) -> List[Tuple[str, str]]:
    pairs: List[Tuple[str, str]] = []

    def put(dst: str, src: str):
        pairs.extend([(dst + ".weight", src + ".weight"), (dst + ".bias", src + ".bias")])

    def norm(dst: str, src: str):
        pairs.extend([(dst + "_scale", src + ".weight"), (dst + "_bias", src + ".bias")])

    def resblock(dst: str, src: str, shortcut: bool):
        norm(dst + ".norm1", src + ".norm1")
        norm(dst + ".norm2", src + ".norm2")
        put(dst + ".conv1", src + ".conv1")
        put(dst + ".conv2", src + ".conv2")
        if shortcut:
            put(dst + ".nin_shortcut", src + ".nin_shortcut")

    def attnblock(dst: str, src: str):
        norm(dst + ".norm", src + ".norm")
        for n in ("q", "k", "v", "proj_out"):
            put(f"{dst}.{n}", f"{src}.{n}")

    def mid(side: str):
        resblock(f"{side}.mid_block_1", f"{side}.mid.block_1", False)
        attnblock(f"{side}.mid_attn_1", f"{side}.mid.attn_1")
        resblock(f"{side}.mid_block_2", f"{side}.mid.block_2", False)

    nm = len(cfg.ch_mult)
    in_mults = (1,) + tuple(cfg.ch_mult)
    put("encoder.conv_in", "encoder.conv_in")
    for i in range(nm):
        for j in range(cfg.num_res_blocks):
            cin = cfg.ch * (in_mults[i] if j == 0 else cfg.ch_mult[i])
            resblock(f"encoder.down_{i}_block_{j}", f"encoder.down.{i}.block.{j}",
                     cin != cfg.ch * cfg.ch_mult[i])
        if i != nm - 1:
            put(f"encoder.down_{i}_downsample.conv", f"encoder.down.{i}.downsample.conv")
    mid("encoder")
    norm("encoder.norm_out", "encoder.norm_out")
    put("encoder.conv_out", "encoder.conv_out")

    put("decoder.conv_in", "decoder.conv_in")
    mid("decoder")
    block_in = cfg.ch * cfg.ch_mult[-1]
    for i in reversed(range(nm)):
        cout = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            cin = block_in if j == 0 else cout
            resblock(f"decoder.up_{i}_block_{j}", f"decoder.up.{i}.block.{j}", cin != cout)
        block_in = cout
        if i != 0:
            put(f"decoder.up_{i}_upsample.conv", f"decoder.up.{i}.upsample.conv")
    norm("decoder.norm_out", "decoder.norm_out")
    put("decoder.conv_out", "decoder.conv_out")
    put("quant_conv", "quant_conv")
    put("post_quant_conv", "post_quant_conv")
    return pairs


def map_vae_state_dict(sd: Dict[str, torch.Tensor], cfg: VAEConfig,
                       prefix: str = VAE_PREFIX) -> Dict[str, torch.Tensor]:
    return strict_map(sd, _name_pairs(cfg), prefix, "VAE")


def ldm_vae_state_dict(vae_sd: Dict[str, torch.Tensor], cfg: VAEConfig,
                       prefix: str = VAE_PREFIX) -> Dict[str, torch.Tensor]:
    """The inverse map: the port's VAE state dict in LDM names."""
    return {prefix + src: vae_sd[dst] for dst, src in _name_pairs(cfg)}
