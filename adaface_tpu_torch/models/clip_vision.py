"""CLIP vision transformer with a spatial attention mask (counterpart of
`adaface_tpu/models/clip_vision.py`).

The reference monkey-patches HF's `CLIPVisionTransformer.forward` to take a
[B, H, W] mask, resizes it to the patch grid, prepends an always-on CLS slot
and hands the pairwise product `mask^T mask` to the encoder as its attention
mask. HF *adds* that {0,1} matrix to the logits, so in-mask pairs get a +1
bias (`mask_mode="bias"`, the default); `"hard"` masks the other pairs out
with finfo(float32).min. The zero-shot path reads `hidden_states[-2]`.

Submodules carry the flax tree's names (`layers_3.self_attn.q_proj`, ...).
The patch embedding is a strided conv and the attention uses plain ops, as
XLA ran them: no kernel of this module is a TPU kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from adaface_tpu_torch.ops.basic import conv_nhwc, quick_gelu, resize_aa


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5

    @classmethod
    def vit_l_14(cls, **kw) -> "CLIPVisionConfig":
        return cls(**kw)

    @classmethod
    def vit_b_32(cls, **kw) -> "CLIPVisionConfig":
        d = dict(hidden_size=768, num_layers=12, num_heads=12,
                 intermediate_size=3072, patch_size=32)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny(cls, **kw) -> "CLIPVisionConfig":
        d = dict(hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, image_size=28, patch_size=14)
        d.update(kw)
        return cls(**d)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.grid * self.grid + 1


class VisionAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, mask_mode: str = "bias"):
        super().__init__()
        if mask_mode not in ("bias", "hard"):
            raise ValueError(f"mask_mode must be 'bias' or 'hard', not {mask_mode!r}")
        w = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.mask_mode = mask_mode
        self.q_proj = nn.Linear(w, w)
        self.k_proj = nn.Linear(w, w)
        self.v_proj = nn.Linear(w, w)
        self.out_proj = nn.Linear(w, w)

    def forward(self, x: torch.Tensor, pair_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, l, w = x.shape
        h = self.num_heads
        d = w // h
        split = lambda t: t.view(b, l, h, d).transpose(1, 2)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul((q * d ** -0.5).float(), k.float().transpose(-1, -2))
        if pair_mask is not None:
            # pair_mask [B, L, L] in {0, 1}: 1 where both tokens are in the mask
            if self.mask_mode == "bias":
                logits = logits + pair_mask[:, None].float()
            else:
                logits = logits.masked_fill(~pair_mask[:, None].bool(),
                                            torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return self.out_proj(torch.matmul(probs, v).transpose(1, 2).reshape(b, l, w))


class VisionEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, mask_mode: str = "bias"):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = VisionAttention(cfg, mask_mode)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, pair_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), pair_mask)
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


def resize_mask_to_grid(mask: torch.Tensor, grid: int) -> torch.Tensor:
    """[B, H, W] spatial mask -> [B, grid*grid + 1] token mask, an always-on
    CLS slot first. Nearest rows and columns floor(i * H / grid), the index
    computed in float32 as the JAX package computes it (torch's 'nearest')."""
    B, H, W = mask.shape
    pick = lambda n: torch.from_numpy(
        (np.arange(grid, dtype=np.float32) * np.float32(n / grid)).astype(np.int64)
    ).to(mask.device)
    small = mask[:, pick(H)][:, :, pick(W)].reshape(B, grid * grid)
    return torch.cat([torch.ones((B, 1), dtype=small.dtype, device=mask.device), small], dim=1)


class CLIPVisionEncoder(nn.Module):
    """The vision tower: all-token features, the pooled (post-LN CLS) output
    and the token mask."""

    def __init__(self, cfg: CLIPVisionConfig, mask_mode: str = "bias"):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.empty(D))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, D, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_tokens, D)
        self.pre_layrnorm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", VisionEncoderLayer(cfg, mask_mode))
        self.post_layernorm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                feature_layer: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """pixel_values [B, H, W, 3] NHWC, CLIP-normalized; attn_mask
        [B, H, W] in {0, 1}. Returns (features [B, L, D], pooled [B, D],
        token_mask [B, L, 1] or None). `feature_layer` indexes the hidden
        states as HF's `hidden_states` does (0 the embeddings, -1 the last
        layer's output); None is the last layer's output."""
        c = self.cfg
        dtype = self.patch_embedding.weight.dtype
        patches = conv_nhwc(self.patch_embedding, pixel_values.to(dtype))  # [B, g, g, D]
        B = patches.shape[0]
        tokens = patches.reshape(B, c.grid * c.grid, c.hidden_size)
        cls = self.class_embedding.to(tokens.dtype).expand(B, 1, c.hidden_size)
        x = torch.cat([cls, tokens], dim=1) + self.position_embedding.weight
        x = self.pre_layrnorm(x)
        token_mask = pair_mask = None
        if attn_mask is not None:
            token_mask = resize_mask_to_grid(attn_mask, c.grid)  # [B, L]
            pair_mask = token_mask[:, :, None] * token_mask[:, None, :]
        hidden = [x]  # hidden[i] is HF's hidden_states[i]
        for i in range(c.num_layers):
            x = getattr(self, f"layers_{i}")(x, pair_mask)
            hidden.append(x)
        feats = hidden[feature_layer] if feature_layer is not None else x
        pooled = self.post_layernorm(x[:, 0])
        return feats, pooled, (token_mask[..., None] if token_mask is not None else None)


# CLIP image preprocessing constants (OpenAI CLIPImageProcessor)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_images(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] uint8 or float in [0, 255] -> CLIP-normalized fp32
    [B, S, S, 3]: the bilinear resize of `jax.image.resize` (antialiased
    when it shrinks), then the per-channel normalization."""
    x = torch.as_tensor(images).float() / 255.0
    x = resize_aa(x.permute(0, 3, 1, 2), image_size, image_size).permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
