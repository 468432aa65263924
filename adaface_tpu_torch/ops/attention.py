"""Subject-token convolutional attention (counterpart of `conv_attn_scores`
and `apply_conv_attn` in `adaface_tpu/ops/attention.py`; the reference's
`replace_rows_by_conv_attn`).

In a cross-attention with conv attention, the first ks*ks subject slots'
key embeddings form a ks x ks kernel of a grouped conv over the query
feature map (one group a head); the map, scaled by sim_scale / ks**1.5,
replaces the scores of those subject tokens, each slot taking a copy
shifted by its (dy, dx) offset. The padding per kernel size is
`_CONV_ATTN_PADS` (left, right, top, bottom), the shifts run dy outer and
dx inner, and what a shift moves in is zero. Rows (instances) without the
subject token are unchanged: the slot map is dense, -1 where no slot. The
conv runs in fp32 (`F.conv2d`; JAX leaves it to XLA with fp32
accumulation) over all instances at once, one group per (instance, head).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# (left, right, top, bottom) per kernel size
_CONV_ATTN_PADS = {2: (0, 1, 0, 1), 3: (1, 1, 1, 1), 4: (1, 2, 1, 2)}


def _onehot(slot_map: torch.Tensor, m: int, dtype) -> torch.Tensor:
    """[B, T, m]: slot_map[b, t] == j."""
    return (slot_map[:, :, None] == torch.arange(m, device=slot_map.device)).to(dtype)


def conv_attn_scores(q: torch.Tensor, k: torch.Tensor, slot_map: torch.Tensor,
                     hw: Tuple[int, int], ks: int, sim_scale: float,
                     shift_attn_maps: bool = True) -> torch.Tensor:
    """q [B, h, N, d] (unscaled), k [B, h, T, d], slot_map [B, T] -> the
    [ks*ks, B, h, N] fp32 score maps of the subject slots 0..ks*ks-1."""
    B, h, N, d = q.shape
    H, W = hw
    m = ks * ks
    subj_k = torch.einsum("bhtd,btm->bhmd", k.float(), _onehot(slot_map, m, torch.float32))
    left, right, top, bottom = _CONV_ATTN_PADS[ks]
    # [1, B*h*d, H, W] input, [B*h, d, ks, ks] kernels: group (b, head)
    x = q.float().reshape(B * h, H, W, d).permute(0, 3, 1, 2).reshape(1, B * h * d, H, W)
    w = subj_k.reshape(B * h, ks, ks, d).permute(0, 3, 1, 2)
    maps = F.conv2d(F.pad(x, (left, right, top, bottom)), w, groups=B * h)
    maps = maps.reshape(B, h, H, W) * (sim_scale / ks ** 1.5)
    if not shift_attn_maps:
        return maps.reshape(B, h, N)[None].expand(m, B, h, N)
    outs = []
    for dy in range(-top, bottom + 1):
        for dx in range(-left, right + 1):
            s = torch.roll(maps, (dy, dx), dims=(2, 3))
            if dy > 0:
                s[:, :, :dy, :] = 0.0
            elif dy < 0:
                s[:, :, dy:, :] = 0.0
            if dx > 0:
                s[:, :, :, :dx] = 0.0
            elif dx < 0:
                s[:, :, :, dx:] = 0.0
            outs.append(s.reshape(B, h, N))
    return torch.stack(outs)


def apply_conv_attn(sim: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                    slot_map: torch.Tensor, hw: Tuple[int, int], ks: int, sim_scale: float,
                    mix_weight: float = 1.0) -> torch.Tensor:
    """sim [B, h, N, T] pre-softmax scores with the subject slots' columns
    replaced by their conv scores (mix_weight 1 replaces them fully); the
    identity for ks <= 1."""
    if ks <= 1:
        return sim
    m = ks * ks
    conv = conv_attn_scores(q, k, slot_map, hw, ks, sim_scale)
    onehot = _onehot(slot_map, m, sim.dtype)
    conv_sel = torch.einsum("mbhn,btm->bhnt", conv.to(sim.dtype), onehot)
    is_subj = ((slot_map >= 0) & (slot_map < m)).to(sim.dtype)
    w = mix_weight * is_subj[:, None, None, :]
    return sim * (1.0 - w) + conv_sel * w
