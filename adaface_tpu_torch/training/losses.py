"""Training losses of the recon iteration (counterpart of the first part of
`adaface_tpu/training/losses.py`): masked reconstruction, the static
prompt-delta regularizer, the embedding-norm regularizer, and the
complementary / suppression / cross-layer attention losses on the captured
cross-attention scores, with their shared helpers (ortho subtract, weighted
cosine, masked means, normalized sums; `grad_scale` is `ops.grad.scale_grad`).
Dense-mask forms throughout; the per-layer weight tables are the JAX
package's. The options of the JAX helpers that only the compositional and
webdataset losses use (margins, squared means, sqrt-normalized scores,
reweighted sums) and those losses themselves are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from adaface_tpu_torch.ops.grad import scale_grad as grad_scale


def masked_recon_loss(eps_pred: torch.Tensor, eps_target: torch.Tensor,
                      fg_mask: Optional[torch.Tensor] = None, bg_weight: float = 0.0,
                      img_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked MSE of the eps prediction: foreground pixels weigh 1,
    background `bg_weight`; `img_mask` (the augmentation's valid area) zeroes
    the empty margins. Averaged over the weighted pixel count."""
    err = torch.square(eps_pred.float() - eps_target.float())
    if fg_mask is None and img_mask is None:
        return err.mean()
    if fg_mask is not None:
        w = fg_mask + (1.0 - fg_mask) * bg_weight
    else:
        w = torch.ones(err.shape[:-1] + (1,), dtype=torch.float32, device=err.device)
    if img_mask is not None:
        w = w * img_mask
    w = w.expand(err.shape)
    return torch.sum(err * w) / torch.clamp_min(torch.sum(w), 1e-6)


def ortho_subtract(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """a minus its projection onto b along the last dim."""
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    norm = torch.sum(b * b, dim=-1, keepdim=True)
    return a - dot / (norm + eps) * b


def _demean(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(dim=-1, keepdim=True)


def _sum(x: torch.Tensor, axis, keepdims: bool = False) -> torch.Tensor:
    if axis is None:
        return x.sum()
    return x.sum(dim=axis, keepdim=keepdims)


def ref_cosine_loss(delta, ref_delta, emb_weights=None, exponent: float = 2.0,
                    do_demean_first: bool = True, ref_grad_scale: float = 0.05,
                    aim_to_align: bool = True,
                    instance_axis: Optional[int] = None) -> torch.Tensor:
    """Weighted cosine alignment of `delta` to `ref_delta`: demean both over
    the last dim, gradient-scale and signed-pow the reference side
    (x |x|^(e-1)), per-token cosine loss, weight-averaged (per instance
    along `instance_axis` when given, each instance counting equally)."""
    if do_demean_first:
        delta = _demean(delta)
        ref_delta = _demean(ref_delta)
    ref_delta = grad_scale(ref_delta, ref_grad_scale)
    ref_pow = ref_delta * torch.abs(ref_delta) ** (exponent - 1.0)
    # eps inside the sqrt: the norm's gradient stays finite at zero vectors
    safe_norm = lambda x: torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)
    cos = torch.sum(delta / safe_norm(delta) * (ref_pow / safe_norm(ref_pow)), dim=-1)
    losses = (1.0 - cos) if aim_to_align else torch.clamp_min(cos, 0.0)
    if emb_weights is not None and instance_axis is not None:
        w = emb_weights.expand(losses.shape)
        axes = tuple(i for i in range(losses.dim()) if i != instance_axis)
        return (torch.sum(losses * w, dim=axes) / (torch.sum(w, dim=axes) + 1e-8)).mean()
    if emb_weights is not None:
        w = emb_weights.expand(losses.shape)
        return torch.sum(losses * w) / (torch.sum(w) + 1e-8)
    return losses.mean()


def prompt_delta_loss(subj_single: torch.Tensor, subj_comp: torch.Tensor,
                      cls_single: torch.Tensor, cls_comp: torch.Tensor,
                      single_mask: Optional[torch.Tensor] = None,
                      comp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Static prompt-delta regularizer on [L, B, T, D] prompt embeddings:
    ortho-subtracted comp-single deltas of the subject prompts aligned to
    those of the class prompts, token weights (m_single + m_comp)^2 / 4 with
    BOS excluded, each instance's weighted mean counting equally."""
    d_subj = ortho_subtract(subj_comp, subj_single)
    d_cls = ortho_subtract(cls_comp, cls_single)
    weights = None
    if single_mask is not None and comp_mask is not None:
        agg = single_mask.float() + comp_mask.float()
        weights = agg ** 2 / 4.0
        weights[:, 0] = 0.0  # exclude BOS
        weights = weights[None]  # broadcast over L
    return ref_cosine_loss(d_subj, d_cls, emb_weights=weights, instance_axis=1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None, keepdims: bool = False,
                instance_weights: Optional[torch.Tensor] = None,
                eps: float = 1e-8) -> torch.Tensor:
    """Mean of x over the elements where mask is truthy, each instance's
    mask scaled by `instance_weights`."""
    m = mask.float()
    v = x.float()
    if instance_weights is not None:
        m = m * instance_weights.reshape((m.shape[0],) + (1,) * (m.dim() - 1))
    return _sum(v * m, axis, keepdims) / (_sum(m, axis, keepdims) + eps)


def normalized_sum(losses: List[torch.Tensor]) -> torch.Tensor:
    """Sum of per-layer losses (0 for none), the JAX helper at norm_pow 0."""
    return sum(losses) if losses else torch.tensor(0.0)


# Per-cross-attention-layer alignment weights (normalized below).
ATTN_ALIGN_LAYER_WEIGHTS = {7: 0.5, 8: 0.5, 12: 1.0, 16: 1.0, 17: 1.0,
                            18: 1.0, 19: 1.0, 20: 1.0, 21: 1.0, 22: 1.0,
                            23: 1.0, 24: 1.0}
# Cross-layer alignment maps and weights.
XLAYER_WEIGHTS = {8: 0.5, 12: 1.0, 16: 1.0, 17: 1.0, 18: 1.0, 19: 0.5,
                  20: 0.5, 21: 0.5, 22: 0.25, 23: 0.25, 24: 0.25}
XLAYER_MAPS = {8: 7, 12: 8, 16: 12, 17: 16, 18: 17, 19: 18, 20: 19,
               21: 20, 22: 21, 23: 22, 24: 23}


def _normalize_weights(d: dict) -> dict:
    s = sum(d.values())
    return {k: v / s for k, v in d.items()}


def _token_score(attn: torch.Tensor, token_mask: torch.Tensor) -> torch.Tensor:
    """[B, h, Q, T] x [B, T] -> [B, h, Q]: scores summed over the token slots."""
    return torch.einsum("bhqt,bt->bhq", attn.float(), token_mask.float())


def _bilinear_2tap(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """[B, H, W] bilinear resize with torch F.interpolate(mode='bilinear',
    align_corners=False) semantics, written out (half-pixel mapping, 2 taps
    per axis, no antialias), as the JAX package writes it."""
    x = x.float()
    B, H, W = x.shape
    dev = x.device
    ys = torch.clamp((torch.arange(oh, device=dev) + 0.5) * (H / oh) - 0.5, 0, H - 1)
    xs = torch.clamp((torch.arange(ow, device=dev) + 0.5) * (W / ow) - 0.5, 0, W - 1)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp_max(y0 + 1, H - 1)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    wy = (ys - y0)[None, :, None]
    wx = (xs - x0)[None, None, :]
    top = x[:, y0][:, :, x0] * (1 - wx) + x[:, y0][:, :, x1] * wx
    bot = x[:, y1][:, :, x0] * (1 - wx) + x[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def _resize_fg_mask_to_q(fg_mask: torch.Tensor, q_len: int) -> torch.Tensor:
    """[B, H, W(, 1)] mask -> binarized [B, Q] at the attention's resolution:
    max of the nearest and the bilinear downsample, > 1e-6."""
    if fg_mask.dim() == 4:
        fg_mask = fg_mask[..., 0]
    fg_mask = fg_mask.float()
    B, H, W = fg_mask.shape
    s = int(round(q_len ** 0.5))
    dev = fg_mask.device
    ri = (torch.arange(s, device=dev) * (H / s)).long()
    ci = (torch.arange(s, device=dev) * (W / s)).long()
    near = fg_mask[:, ri][:, :, ci]
    small = torch.maximum(near, _bilinear_2tap(fg_mask, s, s)).reshape(B, s * s)
    return (small > 1e-6).float()


def fg_mb_suppress_loss(ca_attnscores: Dict[int, torch.Tensor],
                        subj_token_mask: torch.Tensor, fg_mask: torch.Tensor,
                        instance_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Subject-token scores in the background must stay 0.4 below the
    subject's mean score inside the fg mask."""
    weights = _normalize_weights(ATTN_ALIGN_LAYER_WEIGHTS)
    losses = []
    for idx, attn in ca_attnscores.items():
        if idx not in weights:
            continue
        subj_score = _token_score(attn, subj_token_mask)  # [B, h, Q]
        fg3 = _resize_fg_mask_to_q(fg_mask, subj_score.shape[-1])[:, None]
        fg3 = fg3.expand(subj_score.shape)
        bg3 = 1.0 - fg3
        subj_at_mf = grad_scale(subj_score * fg3, 0.5)
        subj_at_mb = subj_score * bg3
        avg_mf = masked_mean(subj_at_mf, fg3, axis=(1, 2), keepdims=True)
        excess = subj_at_mb + 0.4 - avg_mf
        loss = masked_mean(excess, excess > 0, instance_weights=instance_mask)
        losses.append(loss * weights[idx] * 0.05)
    return normalized_sum(losses)


def fg_bg_complementary_loss(ca_attnscores: Dict[int, torch.Tensor],
                             subj_token_mask: torch.Tensor, bg_token_mask: torch.Tensor,
                             fg_mask: Optional[torch.Tensor] = None,
                             instance_mask: Optional[torch.Tensor] = None,
                             fg_grad_scale: float = 0.1):
    """Subject vs background token score complementarity plus the margin
    suppressions. Returns (complementary, subj_mb_suppress, bg_mf_suppress,
    fg_bg_mask_contrast)."""
    weights = _normalize_weights(ATTN_ALIGN_LAYER_WEIGHTS)
    subj_mb_scale, bg_mf_scale, contrast_scale = 0.05, 0.1, 0.05
    mfmb_margin = 0.4
    subj_m = subj_token_mask.float()
    bg_m = bg_token_mask.float()
    K_fg = torch.clamp_min(torch.mean(torch.sum(subj_m, dim=-1)), 1.0)
    K_bg = torch.clamp_min(torch.mean(torch.sum(bg_m, dim=-1)), 1.0)
    subj_bg_at_mf_margin = 0.4 * K_fg / K_bg
    bg_subj_at_mb_margin = 0.4

    def hinge(excess):
        return masked_mean(excess, excess > 0, instance_weights=instance_mask)

    l_comple, l_subj_mb, l_bg_mf, l_contrast = [], [], [], []
    for idx, attn in ca_attnscores.items():
        if idx not in weights:
            continue
        w = weights[idx]
        subj_score = _token_score(attn, subj_token_mask)
        bg_score = _token_score(attn, bg_token_mask)
        # push the bg scores to be orthogonal to the subject scores
        l_comple.append(w * ref_cosine_loss(
            bg_score, subj_score, exponent=2.0, do_demean_first=False,
            ref_grad_scale=fg_grad_scale, aim_to_align=False))
        if fg_mask is None:
            continue
        fg3 = _resize_fg_mask_to_q(fg_mask, subj_score.shape[-1])[:, None]
        fg3 = fg3.expand(subj_score.shape)
        bg3 = 1.0 - fg3
        subj_at_mf = grad_scale(subj_score * fg3, 0.5)
        bg_at_mf = bg_score * fg3
        subj_at_mb = subj_score * bg3
        bg_at_mb = bg_score * bg3
        avg_subj_mf = masked_mean(subj_at_mf, fg3, axis=(1, 2), keepdims=True)
        avg_bg_mb = masked_mean(bg_at_mb, bg3, axis=(1, 2), keepdims=True)
        l_subj_mb.append(w * subj_mb_scale * hinge(subj_at_mb + mfmb_margin - avg_subj_mf))
        l_bg_mf.append(w * bg_mf_scale * hinge(bg_at_mf + mfmb_margin - avg_bg_mb))
        l_contrast.append(w * contrast_scale * (
            hinge(bg_at_mf + subj_bg_at_mf_margin - avg_subj_mf)
            + hinge(subj_at_mb + bg_subj_at_mb_margin - avg_bg_mb)))
    return (normalized_sum(l_comple), normalized_sum(l_subj_mb),
            normalized_sum(l_bg_mf), normalized_sum(l_contrast))


def fg_bg_xlayer_consist_loss(ca_attnscores: Dict[int, torch.Tensor],
                              subj_token_mask: torch.Tensor,
                              bg_token_mask: Optional[torch.Tensor] = None):
    """Cross-layer consistency: each layer's head-averaged subject (and bg)
    score map, bilinear-resized to the coarser grid, cosine-aligned with the
    layer below. Returns (fg_consist, bg_consist)."""
    weights = _normalize_weights(XLAYER_WEIGHTS)

    def head_avg_map(attn, token_mask):  # [B, h, Q, T] -> [B, Q]
        return torch.einsum("bhqt,bt->bq", attn.float(), token_mask.float()) / attn.shape[1]

    l_fg, l_bg = [], []
    for idx, attn in ca_attnscores.items():
        if idx not in weights or XLAYER_MAPS[idx] not in ca_attnscores:
            continue
        w = weights[idx]
        attn_x = ca_attnscores[XLAYER_MAPS[idx]]
        if attn_x.shape[2] > attn.shape[2]:
            attn, attn_x = attn_x, attn
        for masks, acc in ((subj_token_mask, l_fg), (bg_token_mask, l_bg)):
            if masks is None:
                continue
            a = head_avg_map(attn, masks)
            ax = head_avg_map(attn_x, masks)
            s = int(round(a.shape[1] ** 0.5))
            sx = int(round(ax.shape[1] ** 0.5))
            a_small = _bilinear_2tap(a.reshape(a.shape[0], s, s), sx, sx)
            a_small = a_small.reshape(a.shape[0], sx * sx)
            acc.append(w * ref_cosine_loss(a_small, ax, exponent=2.0,
                                           do_demean_first=True, ref_grad_scale=1.0))
    return normalized_sum(l_fg), normalized_sum(l_bg)


def embedding_norm_loss(emb: torch.Tensor, target_norm: float = 1.0) -> torch.Tensor:
    """Keep subject embedding norms near `target_norm` (eps inside the
    sqrt keeps the gradient finite at zero embeddings)."""
    norms = torch.sqrt(torch.sum(torch.square(emb.float()), dim=-1) + 1e-12)
    return torch.mean(torch.square(norms - target_norm))
