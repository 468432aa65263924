"""Compel-style CFG embedding weighting (counterpart of
`adaface_tpu/ops/compel.py`): a prompt context's offset from the empty
prompt's context scaled by 1.1**level, blended per instance.

The draw (probability, level, instance mask) is made on the host by
`sample_compel_cfg` with the trainer's numpy RNG, in the JAX package's
order; `apply_compel_cfg` is the tensor math, and level 0 returns the
context itself.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def apply_compel_cfg(context: torch.Tensor, empty_context: torch.Tensor, weight_level,
                     batch_mask: Optional[torch.Tensor] = None,
                     skipped_token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(ctx - empty) * 1.1**level + empty, kept at `skipped_token_mask`
    tokens and blended per instance by `batch_mask` [B] (1 = apply).
    context [..., B, T, D]; empty_context broadcastable to it."""
    if isinstance(weight_level, (int, float)) and weight_level == 0:
        return context
    w = 1.1 ** torch.as_tensor(weight_level, dtype=context.dtype, device=context.device)
    out = (context - empty_context) * w + empty_context
    if skipped_token_mask is not None:
        keep = skipped_token_mask.to(context.dtype)[..., :, None]
        out = context * keep + out * (1.0 - keep)
    if batch_mask is not None:
        bm = batch_mask.to(context.dtype)[..., :, None, None]
        out = out * bm + context * (1.0 - bm)
    return out


def sample_compel_cfg(rng: np.random.Generator, prob: float, level_or_range,
                      n_instances: int, is_training: bool = True
                      ) -> Tuple[float, Optional[np.ndarray]]:
    """(weight_level, batch_mask) for one iteration: level 0 and no mask
    when the probability gate fails; a level drawn from the range; in
    training, half the applied iterations exempt the first half of the batch
    (the subject rows of the 4-type compos batch)."""
    if prob <= 0 or level_or_range is None or rng.random() > prob:
        return 0.0, None
    if isinstance(level_or_range, (list, tuple)):
        level = float(rng.uniform(level_or_range[0], level_or_range[1]))
    else:
        level = float(level_or_range)
    mask = None
    if is_training and rng.random() < 0.5:
        mask = np.ones((n_instances,), np.float32)
        mask[: n_instances // 2] = 0.0
    return level, mask
