"""CLIP ViT-L/14 text encoder (counterpart of `adaface_tpu/models/clip_text.py`).

Submodules carry the flax tree's names (`layers_3.self_attn.q_proj`, ...), so
the weight bridge is mechanical. `embed_tokens` exposes the token lookup over
the base vocabulary plus an extra table for placeholder ids (ids >=
vocab_size), so the personalization layer can patch rows before the
transformer; `forward` blends the last `num_skip_layers` hidden states with
normalized `skip_weights` before the final LayerNorm (clip skip).
`kv_multipliers` gives each layer m K/V copies of every token (the
reference's `CLIPAttentionMKV`, made by `personalization.arc2face.
extend_clip_mkv_params`): softmax runs over the m-times-longer key axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn

from adaface_tpu_torch.ops.basic import quick_gelu


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    num_extra_tokens: int = 0  # appended placeholder rows
    kv_multipliers: Optional[tuple] = None  # per-layer K/V copies; None = all 1

    @classmethod
    def vit_l_14(cls, **kw) -> "CLIPTextConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "CLIPTextConfig":
        d = dict(vocab_size=99, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position_embeddings=16)
        d.update(kw)
        return cls(**d)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, kv_multiplier: int = 1):
        super().__init__()
        w = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.kv_multiplier = kv_multiplier
        self.q_proj = nn.Linear(w, w)
        self.k_proj = nn.Linear(w, w * kv_multiplier)
        self.v_proj = nn.Linear(w, w * kv_multiplier)
        self.out_proj = nn.Linear(w, w)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        b, l, w = x.shape
        h = self.num_heads
        d = w // h
        m = self.kv_multiplier
        split = lambda t: t.view(b, l, h, d).transpose(1, 2)
        # K/V copies lie [tok0_c0, .., tok0_c(m-1), tok1_c0, ..]: the copy
        # index innermost, next to the sequence
        split_kv = split if m == 1 else (
            lambda t: t.view(b, l, m, h, d).permute(0, 3, 1, 2, 4).reshape(b, h, l * m, d))
        q, k, v = split(self.q_proj(x)), split_kv(self.k_proj(x)), split_kv(self.v_proj(x))
        # fp32 score product, as the JAX encoder's preferred_element_type
        logits = torch.matmul((q * d ** -0.5).float(), k.float().transpose(-1, -2))
        # finfo.min, not -inf, as the JAX encoder masks
        mask = causal if m == 1 else causal.repeat_interleave(m, dim=-1)
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, w)
        return self.out_proj(out)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, kv_multiplier: int = 1):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg, kv_multiplier)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        if cfg.num_extra_tokens > 0:
            self.extra_token_embedding = nn.Embedding(cfg.num_extra_tokens, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        mults = cfg.kv_multipliers or (1,) * cfg.num_layers
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", CLIPEncoderLayer(cfg, mults[i]))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, L] ids -> [B, L, D] over the base plus the extra vocabulary."""
        c = self.cfg
        base = self.token_embedding(input_ids.clamp(max=c.vocab_size - 1))
        if c.num_extra_tokens == 0:
            return base
        extra = self.extra_token_embedding(
            (input_ids - c.vocab_size).clamp(0, c.num_extra_tokens - 1))
        return torch.where((input_ids >= c.vocab_size)[..., None], extra, base)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                input_embeds: Optional[torch.Tensor] = None,
                skip_weights: Optional[Sequence[float]] = None,
                num_skip_layers: int = 2) -> torch.Tensor:
        """[B, L, D]: the final-LN'd blend of the last `num_skip_layers` of
        the (num_layers + 1) hidden states; with skip_weights None or one
        layer, the plain last hidden state."""
        c = self.cfg
        if input_embeds is None:
            input_embeds = self.embed_tokens(input_ids)
        b, l, _ = input_embeds.shape
        pos = self.position_embedding(torch.arange(l, device=input_embeds.device))
        x = input_embeds + pos[None]
        causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
        n = min(max(1, num_skip_layers), c.num_layers + 1)
        collected = [x] if n > c.num_layers else []
        for i in range(c.num_layers):
            x = getattr(self, f"layers_{i}")(x, causal)
            if i + 1 >= c.num_layers + 1 - n:
                collected.append(x)
        if skip_weights is None or n == 1:
            blended = x
        else:
            w = torch.as_tensor(skip_weights, dtype=torch.float32, device=x.device)[-n:]
            if w.dim() == 1:
                w = w[:, None]
            w = w / w.sum(dim=0, keepdim=True)
            stack = torch.stack(collected, dim=0).float()
            blended = (stack * w[:, None, None, :]).sum(dim=0).to(x.dtype)
        return self.final_layer_norm(blended)
