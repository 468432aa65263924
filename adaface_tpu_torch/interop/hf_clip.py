"""HuggingFace `CLIPTextModel` state dict -> the port's `CLIPTextEncoder`
state dict (counterpart of `map_clip_text_params` in
`adaface_tpu/interop/hf_clip.py`).

HF keeps torch's layouts, so the map renames only: `embeddings.
{token,position}_embedding`, `final_layer_norm` and, per layer,
`encoder.layers.{i}.{self_attn.{q,k,v,out}_proj, layer_norm{1,2},
mlp.fc{1,2}}` -> `layers_{i}.{self_attn.*, layer_norm*, fc*}`. The names sit
under `prefix` ("text_model." in a CLIPTextModel file;
"cond_stage_model.transformer.text_model." in an SD checkpoint). Keys
outside those names (HF's `position_ids` buffer, other towers) are ignored,
as in the JAX map. `hf_clip_text_state_dict` is the inverse.
"""

from __future__ import annotations

from typing import Dict

import torch

from adaface_tpu_torch.models.clip_text import CLIPTextConfig

HF_TEXT_FILES = ("model.safetensors", "pytorch_model.bin")


def _name_pairs(num_layers: int):
    """(port name, HF name without the prefix) of every tensor."""
    pairs = [("token_embedding.weight", "embeddings.token_embedding.weight"),
             ("position_embedding.weight", "embeddings.position_embedding.weight"),
             ("final_layer_norm.weight", "final_layer_norm.weight"),
             ("final_layer_norm.bias", "final_layer_norm.bias")]
    for i in range(num_layers):
        for a, b in (("self_attn.q_proj", "self_attn.q_proj"),
                     ("self_attn.k_proj", "self_attn.k_proj"),
                     ("self_attn.v_proj", "self_attn.v_proj"),
                     ("self_attn.out_proj", "self_attn.out_proj"),
                     ("layer_norm1", "layer_norm1"), ("layer_norm2", "layer_norm2"),
                     ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            for leaf in ("weight", "bias"):
                pairs.append((f"layers_{i}.{b}.{leaf}", f"encoder.layers.{i}.{a}.{leaf}"))
    return pairs


def map_clip_text_state_dict(sd: Dict[str, torch.Tensor], num_layers: int = 12,
                             prefix: str = "text_model.") -> Dict[str, torch.Tensor]:
    return {dst: sd[prefix + src] for dst, src in _name_pairs(num_layers)}


def hf_clip_text_state_dict(encoder_sd: Dict[str, torch.Tensor], num_layers: int,
                            prefix: str = "text_model.") -> Dict[str, torch.Tensor]:
    """The inverse map: a port encoder's state dict in the HF layout."""
    return {prefix + src: encoder_sd[dst] for dst, src in _name_pairs(num_layers)}


def text_config_from_state_dict(sd: Dict[str, torch.Tensor], prefix: str = "text_model."
                                ) -> CLIPTextConfig:
    """The encoder's widths read off its weights: layers, hidden and MLP
    widths, vocabulary and positions; heads the largest of 12, 8, 4, 2, 1
    that divides the width (the JAX loader's rule)."""
    layers = 1 + max(int(k[len(prefix):].split("encoder.layers.")[1].split(".")[0])
                     for k in sd if k.startswith(prefix) and "encoder.layers." in k)
    vocab, hidden = sd[prefix + "embeddings.token_embedding.weight"].shape
    return CLIPTextConfig.vit_l_14(
        vocab_size=int(vocab), hidden_size=int(hidden), num_layers=layers,
        num_heads=next(h for h in (12, 8, 4, 2, 1) if hidden % h == 0),
        intermediate_size=int(sd[prefix + "encoder.layers.0.mlp.fc1.weight"].shape[0]),
        max_position_embeddings=int(sd[prefix + "embeddings.position_embedding.weight"].shape[0]))
