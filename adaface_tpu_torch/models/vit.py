"""Pre-LN Vision Transformer, HF `ViTModel`-compatible (counterpart of
`adaface_tpu/models/vit.py`): the DINO ViT-S/16 scorer's tower.

Conv patch embedding with bias, a prepended CLS token, learned position
embeddings, pre-LN blocks (LayerNorm eps 1e-12, exact GELU, fp32 einsum
attention), a final LayerNorm. Patch tokens follow the grid in row-major
order. Submodules carry the flax tree's names (`layers_3.attention.query`,
...); `map_vit_state_dict` maps an HF `ViTModel` state dict to them. Plain
PyTorch, as XLA ran it: no module here is a TPU kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from adaface_tpu_torch.ops.basic import conv_nhwc, resize_aa


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    intermediate_size: int = 1536
    image_size: int = 224
    patch_size: int = 16
    layer_norm_eps: float = 1e-12

    @classmethod
    def dino_vits16(cls, **kw) -> "ViTConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        d = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                 image_size=32, patch_size=16)
        d.update(kw)
        return cls(**d)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.grid * self.grid + 1


class ViTSelfAttention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        w = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(w, w)
        self.key = nn.Linear(w, w)
        self.value = nn.Linear(w, w)
        self.out = nn.Linear(w, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, w = x.shape
        h = self.num_heads
        d = w // h
        split = lambda t: t.view(b, l, h, d).transpose(1, 2)
        logits = torch.einsum("bhqd,bhkd->bhqk", (split(self.query(x)) * d ** -0.5).float(),
                              split(self.key(x)).float())
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, split(self.value(x)))
        return self.out(out.transpose(1, 2).reshape(b, l, w))


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.layernorm_before = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attention = ViTSelfAttention(cfg)
        self.layernorm_after = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layernorm_before(x))
        y = F.gelu(self.intermediate(self.layernorm_after(x)), approximate="none")
        return x + self.output(y)


class ViTEncoder(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = c = cfg
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, c.num_tokens, c.hidden_size))
        for i in range(c.num_layers):
            self.add_module(f"layers_{i}", ViTLayer(c))
        self.layernorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] NHWC -> the final-LN hidden states [B, L, D]; the CLS
        feature is `out[:, 0]`."""
        c = self.cfg
        dtype = self.patch_embedding.weight.dtype
        patches = conv_nhwc(self.patch_embedding, pixel_values.to(dtype))
        B = patches.shape[0]
        tokens = patches.reshape(B, c.grid * c.grid, c.hidden_size)
        x = torch.cat([self.cls_token.to(tokens.dtype).expand(B, 1, c.hidden_size), tokens],
                      dim=1)
        x = x + self.position_embeddings.to(x.dtype)
        for i in range(c.num_layers):
            x = getattr(self, f"layers_{i}")(x)
        return self.layernorm(x)


# the ImageNet normalization of HF's ViT feature extractor
VIT_IMAGE_MEAN = (0.485, 0.456, 0.406)
VIT_IMAGE_STD = (0.229, 0.224, 0.225)


def preprocess_vit_images(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] uint8 or [0, 255] float -> ImageNet-normalized fp32
    [B, S, S, 3]: `jax.image.resize`'s bilinear (antialiased when it
    shrinks), then the per-channel mean and std."""
    x = torch.as_tensor(images).float() / 255.0
    x = resize_aa(x.permute(0, 3, 1, 2), image_size, image_size).permute(0, 2, 3, 1)
    mean = torch.tensor(VIT_IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(VIT_IMAGE_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def _vit_name_pairs(num_layers: int):
    """(port name, HF name) of every tensor of a ViTModel."""
    pairs = [("cls_token", "embeddings.cls_token"),
             ("position_embeddings", "embeddings.position_embeddings"),
             ("patch_embedding.weight", "embeddings.patch_embeddings.projection.weight"),
             ("patch_embedding.bias", "embeddings.patch_embeddings.projection.bias"),
             ("layernorm.weight", "layernorm.weight"), ("layernorm.bias", "layernorm.bias")]
    for i in range(num_layers):
        for a, b in (("attention.attention.query", "attention.query"),
                     ("attention.attention.key", "attention.key"),
                     ("attention.attention.value", "attention.value"),
                     ("attention.output.dense", "attention.out"),
                     ("layernorm_before", "layernorm_before"),
                     ("layernorm_after", "layernorm_after"),
                     ("intermediate.dense", "intermediate"), ("output.dense", "output")):
            for leaf in ("weight", "bias"):
                pairs.append((f"layers_{i}.{b}.{leaf}", f"encoder.layer.{i}.{a}.{leaf}"))
    return pairs


def map_vit_state_dict(sd: Dict[str, torch.Tensor], num_layers: int = 12,
                       prefix: str = "") -> Dict[str, torch.Tensor]:
    """HF `ViTModel` state dict -> the `ViTEncoder` state dict (HF keeps
    torch's layouts: the map only renames)."""
    return {dst: torch.as_tensor(sd[prefix + src]) for dst, src in _vit_name_pairs(num_layers)}


def hf_vit_state_dict(encoder_sd: Dict[str, torch.Tensor], num_layers: int,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse map: a port encoder's state dict in HF `ViTModel` names."""
    return {prefix + src: encoder_sd[dst] for dst, src in _vit_name_pairs(num_layers)}
