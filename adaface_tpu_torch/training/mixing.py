"""Class-subject V/K embedding mixing for compositional distillation
(counterpart of `adaface_tpu/training/mixing.py`), in the [L, B, T, D]
layerwise layout.

- The V-context mixes the class embedding into the subject token slots with
  a per-layer scale ramping over the sync layers (1.0 -> 0.7 by default);
  the K-context keeps the class embedding (1.0 -> 1.0). Elsewhere both take
  the class embeddings.
- V and K concatenate on the token dim -> [L, B, 2T, D].
- On sync layers a t-dependent blend pulls the mixed context toward the
  plain subject context: subject proportion
  `1 - t_frac * (1 - training_percent * 0.3)`.
- The mixed branch's gradient is scaled by `PROMPT_MIX_GRAD_SCALE`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from adaface_tpu_torch.ops.grad import scale_grad

# cross-attention layers 7, 8, 12, 16..24 in cross-attention index space
SYNC_LAYER_INDICES = (4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
PROMPT_MIX_GRAD_SCALE = 0.05


def gen_layer_cls_mix_scales(num_layers: int, scale_range: Tuple[float, float],
                             sync_layers: Sequence[int] = SYNC_LAYER_INDICES,
                             device=None) -> torch.Tensor:
    """[L] per-layer class-mix scale: 1 outside the sync layers, a linear
    ramp scale_range[0] -> scale_range[1] across them."""
    scales = torch.ones(num_layers, device=device)
    n = len(sync_layers)
    lo, hi = float(scale_range[0]), float(scale_range[1])
    ramp = lo + torch.arange(n, device=device, dtype=torch.float32) * ((hi - lo) / max(n - 1, 1))
    scales[list(sync_layers)] = ramp
    return scales


def mix_embeddings_add(cls_emb: torch.Tensor, subj_emb: torch.Tensor,
                       subj_token_mask: torch.Tensor,
                       layer_cls_scales: torch.Tensor) -> torch.Tensor:
    """[L, B, T, D] class-dominant mix: the class embedding everywhere; at the
    subject slots cls * scale + subj * (1 - scale), per layer."""
    scale = layer_cls_scales.to(cls_emb.dtype)[:, None, None, None]
    tok = subj_token_mask.to(cls_emb.dtype)[None, :, :, None]
    scale_mask = 1.0 - tok * (1.0 - scale)
    return cls_emb * scale_mask + subj_emb * (1.0 - scale_mask)


def mix_static_vk_embeddings(subj_emb: torch.Tensor, cls_emb: torch.Tensor,
                             subj_token_mask: torch.Tensor, training_percent: float,
                             t_frac: torch.Tensor,
                             v_cls_scale_range: Tuple[float, float] = (1.0, 0.7),
                             k_cls_scale_range: Tuple[float, float] = (1.0, 1.0),
                             sync_layers: Sequence[int] = SYNC_LAYER_INDICES
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(subj_vk, mix_vk), each [L, B, 2T, D]: the plain subject context
    token-doubled, and the class-mixed (V; K) context blended toward it on
    the sync layers."""
    L, B = subj_emb.shape[:2]
    dev, dt = subj_emb.device, subj_emb.dtype
    v_scales = gen_layer_cls_mix_scales(L, v_cls_scale_range, sync_layers, dev)
    k_scales = gen_layer_cls_mix_scales(L, k_cls_scale_range, sync_layers, dev)
    mix_v = mix_embeddings_add(cls_emb, subj_emb, subj_token_mask, v_scales)
    mix_k = mix_embeddings_add(cls_emb, subj_emb, subj_token_mask, k_scales)
    mix_all = scale_grad(torch.cat([mix_v, mix_k], dim=2), PROMPT_MIX_GRAD_SCALE)
    subj_vk = torch.cat([subj_emb, subj_emb], dim=2)
    t_frac = torch.as_tensor(t_frac, dtype=dt, device=dev).expand(B)
    subj_prop = 1.0 - t_frac * (1.0 - float(training_percent) * 0.3)  # [B]
    layer_sel = torch.zeros(L, dtype=dt, device=dev)
    layer_sel[list(sync_layers)] = 1.0
    blend = (layer_sel[:, None] * subj_prop[None, :])[:, :, None, None]
    return subj_vk, subj_vk * blend + mix_all * (1.0 - blend)
