"""Arc2Face face-conditioned text encoding (counterpart of
`adaface_tpu/personalization/arc2face.py`).

- forward: "photo of a id person" with the token embedding of "id" replaced
  by the zero-padded 512-d ArcFace embedding; rows 4:20 of the encoder's
  output are the 16 "core" identity prompt embeddings;
- inverse: a "photo of a " + 16 x ", " template whose comma rows 4:20 take
  the core embeddings; a fine-tuned text encoder (`prompt2token_proj`) maps
  them back into the token-embedding space, with several padding variants
  of the full output;
- `extend_clip_mkv_params`: the reference's `CLIPAttentionMKV` K/V capacity
  extension as a transform of a state dict plus a `kv_multipliers` config.

Templates are tokenized on the host once ([1, T] int arrays); every row
index is a static slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from adaface_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from adaface_tpu_torch.ops.grad import add_noise_to_tensor

# "photo of a" is BOS + 3 tokens; then 16 id/comma slots
CORE_BEGIN, CORE_END = 4, 20
NUM_CORE_EMBS = CORE_END - CORE_BEGIN

FORWARD_TEMPLATE = "photo of a id person"
INVERSE_TEMPLATE = "photo of a " + ", " * NUM_CORE_EMBS

ARCFACE_EMB_DIM = 512

EMB_TYPES = ("full", "full_pad", "full_half_pad", "full_zeroed_extra", "b_core_e", "core")


def make_template_ids(tokenizer, template: str, max_length: int = 77) -> np.ndarray:
    """[1, T] int32 ids of a prompt template."""
    return tokenizer([template], max_length=max_length)


def _template_batch(template_ids, batch: int, device) -> torch.Tensor:
    ids = torch.as_tensor(np.asarray(template_ids), dtype=torch.long, device=device)
    return ids.expand(batch, ids.shape[1])


def forward_face_embs(encoder: CLIPTextEncoder, face_embs: torch.Tensor, template_ids,
                      arcface_token_id: int, skip_weights=None, num_skip_layers: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ArcFace embeddings [B, 512] -> (full [B, T, D], core [B, 16, D]).
    The embedding is zero-padded to the encoder's hidden width, or truncated
    where that is under 512."""
    B = face_embs.shape[0]
    hidden_size = encoder.cfg.hidden_size
    ids = _template_batch(template_ids, B, face_embs.device)
    token_embs = encoder.embed_tokens(ids)
    k = min(face_embs.shape[-1], hidden_size)
    padded = torch.nn.functional.pad(face_embs[..., :k], (0, hidden_size - k))
    is_id = (ids == arcface_token_id)[..., None]
    token_embs = torch.where(is_id, padded[:, None, :].to(token_embs.dtype), token_embs)
    full = encoder(input_embeds=token_embs, skip_weights=skip_weights,
                   num_skip_layers=num_skip_layers)
    return full, full[:, CORE_BEGIN:CORE_END]


def inverse_face_prompt_embs(encoder: CLIPTextEncoder, face_prompt_embs: torch.Tensor,
                             template_ids, pad_embeddings: torch.Tensor,
                             return_emb_types: Sequence[str],
                             hidden_state_layer_weights: Optional[torch.Tensor] = None,
                             extra_words_embs: bool = False,
                             zs_extra_words_scale: float = 0.5) -> List[torch.Tensor]:
    """Core identity embeddings [B, 16, D] -> the inverse (token-space)
    prompt embeddings, one per entry of `return_emb_types` (`EMB_TYPES`).
    `pad_embeddings` [T, D] come from `make_pad_embeddings`."""
    for t in return_emb_types:
        if t not in EMB_TYPES:
            raise ValueError(f"unknown emb type {t!r}")
    B = face_prompt_embs.shape[0]
    ids = _template_batch(template_ids, B, face_prompt_embs.device)
    T = ids.shape[1]
    token_embs = encoder.embed_tokens(ids).clone()
    token_embs[:, CORE_BEGIN:CORE_END] = face_prompt_embs.to(token_embs.dtype)
    n_skip = (hidden_state_layer_weights.shape[0]
              if hidden_state_layer_weights is not None else 1)
    full = encoder(input_embeds=token_embs, skip_weights=hidden_state_layer_weights,
                   num_skip_layers=n_skip)

    core = full[:, CORE_BEGIN:CORE_END]
    if extra_words_embs:
        # rows 20:22 hold at most two extra words
        core = torch.cat([core, full[:, CORE_END:CORE_END + 2] * zs_extra_words_scale], dim=1)

    pad = pad_embeddings.to(full.dtype)

    def with_rows(src: torch.Tensor, rows: slice, value) -> torch.Tensor:
        out = src.clone()
        out[:, rows] = value
        return out

    outs: List[torch.Tensor] = []
    for emb_type in return_emb_types:
        if emb_type == "full":
            outs.append(full)
        elif emb_type == "full_pad":
            outs.append(with_rows(full, slice(24, -1), pad[None, 24:-1]))
        elif emb_type == "full_half_pad":
            half = (T - 25) // 2
            outs.append(with_rows(full, slice(24, 24 + half), pad[None, 24:24 + half])
                        if half >= 1 else full)
        elif emb_type == "full_zeroed_extra":
            out = with_rows(full, slice(22, 24), pad[None, 22:24])
            outs.append(with_rows(out, slice(24, -1), 0.0))
        elif emb_type == "b_core_e":
            outs.append(torch.cat([full[:, :22], full[:, -1:]], dim=1))
        else:  # "core"
            outs.append(core)
    return outs


def make_pad_embeddings(encoder: CLIPTextEncoder, pad_token_id: int,
                        length: int = 77) -> torch.Tensor:
    """[T, D] embeddings of an all-pad prompt, positions included (the
    reference's `clip_embeddings(pad_tokens)[0]` adds them)."""
    dev = encoder.token_embedding.weight.device
    ids = torch.full((1, length), pad_token_id, dtype=torch.long, device=dev)
    token = encoder.embed_tokens(ids)[0]
    return token + encoder.position_embedding.weight[:length].to(token.dtype)


def extend_clip_mkv_params(state_dict: Dict[str, torch.Tensor], cfg: CLIPTextConfig,
                           generator: Optional[torch.Generator] = None,
                           multiplier: int = 2, noise_std: float = 0.1,
                           begin_layer_idx: int = -1, end_layer_idx: int = -1
                           ) -> Tuple[Dict[str, torch.Tensor], CLIPTextConfig]:
    """Tile each affected layer's k/v projection `multiplier` times along its
    output rows, the extra copies perturbed by noise of `noise_std` times the
    weights' own std (the JAX package measures it along the output axis of
    its [in, out] kernel), drawn from `generator` layer by layer, k before v.
    Returns (new state dict, config with the new kv_multipliers); the
    numbers of the noise differ from JAX's draws, their law does not."""
    begin = 0 if begin_layer_idx < 0 else begin_layer_idx
    end = cfg.num_layers if end_layer_idx < 0 else end_layer_idx
    mults = list(cfg.kv_multipliers or (1,) * cfg.num_layers)
    sd = dict(state_dict)
    for i in range(begin, min(end, cfg.num_layers)):
        for proj in ("k_proj", "v_proj"):
            wk, bk = f"layers_{i}.self_attn.{proj}.weight", f"layers_{i}.self_attn.{proj}.bias"
            w, b = sd[wk], sd[bk]  # [Dout*m0, Din], [Dout*m0]
            extra = w.repeat(multiplier - 1, 1)
            extra = add_noise_to_tensor(extra.t(), noise_std, generator).t()
            sd[wk] = torch.cat([w, extra], dim=0)
            sd[bk] = b.repeat(multiplier)
        mults[i] *= multiplier
    return sd, dataclasses.replace(cfg, kv_multipliers=tuple(mults))
