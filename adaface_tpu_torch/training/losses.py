"""Training losses (counterpart of `adaface_tpu/training/losses.py`): masked
reconstruction, the static prompt-delta regularizer, the embedding-norm
regularizer, the complementary / suppression / cross-layer attention losses
of the recon iteration, and the compositional-distillation battery (delta
alignment, the prompt-mix feature/attention losses, elastic matching and
the comp fg/bg preservation, and the two regularizers that ship disabled:
padding alignment and the subject/comp K-V orthogonality), with their shared
helpers (ortho subtract, weighted cosine, masked means, normalized sums,
dynamic scales; `grad_scale` is `ops.grad.scale_grad`). Dense-mask forms
throughout; the per-layer weight tables are the JAX package's.

Resizes: the recon battery's and the cross-layer map's are 2-tap bilinear
(torch `F.interpolate` semantics, no antialias), as the JAX package writes
them; the compositional losses' follow `jax.image.resize(..., "bilinear")`,
which antialiases when it shrinks (a triangle kernel widened by the scale,
weights renormalized): `ops.basic.resize_aa` builds those weight matrices on the host.
The complementary loss takes the webdataset call's `do_sqrt_norm`. The JAX
helpers' `do_sqr` (`masked_mean`) and `norm_pow` (`normalized_sum`) have no
caller there, so the port leaves them out.

A loss over a batch that is sliced over dp ranks takes the step's `mesh`
(`parallel/mesh.py`; None: one device) and makes every reduction over the
batch global (`_gsum` / `_gmean`: the value over all ranks, the gradient of
this rank's part scaled to match), so the dp-mean of the ranks' gradients is
the gradient of the global loss: the masked recon's ratio of sums, the
weighted and plain means of `ref_cosine_loss` and its hinge, `masked_mean`
over the batch, the complementary loss's token counts, the prompt-mix
attention norm and feature MSE, the elastic battery's mean over blocks.
A reduction within one block (the elastic matching of a block, the K/V
orthogonality of block 0) is called without a mesh.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from adaface_tpu_torch.ops.basic import resize_aa
from adaface_tpu_torch.ops.grad import scale_grad as grad_scale
from adaface_tpu_torch.parallel import mesh as pmesh


def _gsum(x: torch.Tensor, mesh) -> torch.Tensor:
    """A sum over the batch, global under a dp mesh (`mesh.global_sum`)."""
    return pmesh.global_sum(x, mesh)


def _gmean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of a batch-sliced tensor, global under a dp mesh."""
    return pmesh.global_mean(x, mesh)


def masked_recon_loss(eps_pred: torch.Tensor, eps_target: torch.Tensor,
                      fg_mask: Optional[torch.Tensor] = None, bg_weight: float = 0.0,
                      img_mask: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Masked MSE of the eps prediction: foreground pixels weigh 1,
    background `bg_weight`; `img_mask` (the augmentation's valid area) zeroes
    the empty margins. Averaged over the weighted pixel count (of the global
    batch under a dp `mesh`)."""
    err = torch.square(eps_pred.float() - eps_target.float())
    if fg_mask is None and img_mask is None:
        return _gmean(err, mesh)
    if fg_mask is not None:
        w = fg_mask + (1.0 - fg_mask) * bg_weight
    else:
        w = torch.ones(err.shape[:-1] + (1,), dtype=torch.float32, device=err.device)
    if img_mask is not None:
        w = w * img_mask
    w = w.expand(err.shape)
    return _gsum(torch.sum(err * w), mesh) / torch.clamp_min(_gsum(torch.sum(w), mesh), 1e-6)


def ortho_subtract(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """a minus its projection onto b along the last dim."""
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    norm = torch.sum(b * b, dim=-1, keepdim=True)
    return a - dot / (norm + eps) * b


def cosine_loss(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """1 - mean cosine similarity along the last dim."""
    an = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + eps)
    bn = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + eps)
    return 1.0 - torch.mean(torch.sum(an * bn, dim=-1))


def calc_align_coeffs(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Optimal projection coefficient of a onto b along the last dim."""
    return torch.sum(a * b, dim=-1) / (torch.sum(b * b, dim=-1) + eps)


def _demean(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(dim=-1, keepdim=True)


def _sum(x: torch.Tensor, axis, keepdims: bool = False) -> torch.Tensor:
    if axis is None:
        return x.sum()
    return x.sum(dim=axis, keepdim=keepdims)


def ref_cosine_loss(delta, ref_delta, emb_weights=None, exponent: float = 2.0,
                    do_demean_first: bool = True, ref_grad_scale: float = 0.05,
                    aim_to_align: bool = True, margin: float = 0.0,
                    instance_axis: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Weighted cosine alignment of `delta` to `ref_delta`: demean both over
    the last dim, gradient-scale and signed-pow the reference side
    (x |x|^(e-1)), per-token cosine loss, weight-averaged (per instance
    along `instance_axis` when given, each instance counting equally). A
    `margin` > 0 hinges the mean (per instance with `instance_axis`): no
    gradient until it exceeds the margin. The means are over the batch,
    global under a dp `mesh`."""
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
        per = torch.sum(losses * w, dim=axes) / (torch.sum(w, dim=axes) + 1e-8)
        if margin > 0:
            per = torch.clamp_min(per - margin, 0.0)
        return _gmean(per, mesh)
    if emb_weights is not None:
        w = emb_weights.expand(losses.shape)
        loss = _gsum(torch.sum(losses * w), mesh) / (_gsum(torch.sum(w), mesh) + 1e-8)
    else:
        loss = _gmean(losses, mesh)
    if margin > 0:
        loss = torch.clamp_min(loss - margin, 0.0)
    return loss


def prompt_delta_loss(subj_single: torch.Tensor, subj_comp: torch.Tensor,
                      cls_single: torch.Tensor, cls_comp: torch.Tensor,
                      single_mask: Optional[torch.Tensor] = None,
                      comp_mask: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
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
    return ref_cosine_loss(d_subj, d_cls, emb_weights=weights, instance_axis=1, mesh=mesh)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None, keepdims: bool = False,
                instance_weights: Optional[torch.Tensor] = None,
                eps: float = 1e-8, mesh=None) -> torch.Tensor:
    """Mean of x over the elements where mask is truthy, each instance's
    mask scaled by `instance_weights`; over everything (axis None) the sums
    are global under a dp `mesh`."""
    m = mask.float()
    v = x.float()
    if instance_weights is not None:
        m = m * instance_weights.reshape((m.shape[0],) + (1,) * (m.dim() - 1))
    if axis is None:
        return _gsum(torch.sum(v * m), mesh) / (_gsum(torch.sum(m), mesh) + eps)
    return _sum(v * m, axis, keepdims) / (_sum(m, axis, keepdims) + eps)


def normalized_sum(losses: List[torch.Tensor]) -> torch.Tensor:
    """Sum of per-layer losses (0 for none), the JAX helper at norm_pow 0."""
    return sum(losses) if losses else torch.tensor(0.0)


def calc_dyn_loss_scale(loss_value: float, loss_base: float, loss_scale_base: float,
                        min_scale_base_ratio: float = 1.0,
                        max_scale_base_ratio: float = 2.0) -> float:
    """Host-side dynamic loss scale from a concrete float: value x base scale
    / base loss, clamped to [min, max] x the base scale (0 when the base
    loss is 0)."""
    if loss_base == 0:
        return 0.0
    scale = float(loss_value) * loss_scale_base / loss_base
    return max(min(loss_scale_base * max_scale_base_ratio, scale),
               loss_scale_base * min_scale_base_ratio)


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
                        instance_mask: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
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
        loss = masked_mean(excess, excess > 0, instance_weights=instance_mask, mesh=mesh)
        losses.append(loss * weights[idx] * 0.05)
    return normalized_sum(losses)


def fg_bg_complementary_loss(ca_attnscores: Dict[int, torch.Tensor],
                             subj_token_mask: torch.Tensor, bg_token_mask: torch.Tensor,
                             fg_mask: Optional[torch.Tensor] = None,
                             instance_mask: Optional[torch.Tensor] = None,
                             fg_grad_scale: float = 0.1, do_sqrt_norm: bool = False,
                             mesh=None):
    """Subject vs background token score complementarity plus the margin
    suppressions. Returns (complementary, subj_mb_suppress, bg_mf_suppress,
    fg_bg_mask_contrast). K_fg and K_bg (tokens a subject / bg set) come
    from the masks, which matters for the webdataset call, where the "bg"
    set is the comp-extra tokens. `do_sqrt_norm` (that call's) divides each
    instance's summed scores by the square root of its token count, a
    detached normalizer."""
    weights = _normalize_weights(ATTN_ALIGN_LAYER_WEIGHTS)
    subj_mb_scale, bg_mf_scale, contrast_scale = 0.05, 0.1, 0.05
    mfmb_margin = 0.4
    subj_m = subj_token_mask.float()
    bg_m = bg_token_mask.float()
    K_fg = torch.clamp_min(_gmean(torch.sum(subj_m, dim=-1), mesh), 1.0)
    K_bg = torch.clamp_min(_gmean(torch.sum(bg_m, dim=-1), mesh), 1.0)
    subj_bg_at_mf_margin = 0.4 * K_fg / K_bg
    bg_subj_at_mb_margin = 0.4
    sq_fg = torch.sqrt(torch.clamp_min(torch.sum(subj_m, dim=-1), 1.0)).detach()[:, None, None]
    sq_bg = torch.sqrt(torch.clamp_min(torch.sum(bg_m, dim=-1), 1.0)).detach()[:, None, None]

    def hinge(excess):
        return masked_mean(excess, excess > 0, instance_weights=instance_mask, mesh=mesh)

    l_comple, l_subj_mb, l_bg_mf, l_contrast = [], [], [], []
    for idx, attn in ca_attnscores.items():
        if idx not in weights:
            continue
        w = weights[idx]
        subj_score = _token_score(attn, subj_token_mask)
        bg_score = _token_score(attn, bg_token_mask)
        if do_sqrt_norm:
            subj_score = subj_score / sq_fg
            bg_score = bg_score / sq_bg
        # push the bg scores to be orthogonal to the subject scores
        l_comple.append(w * ref_cosine_loss(
            bg_score, subj_score, exponent=2.0, do_demean_first=False,
            ref_grad_scale=fg_grad_scale, aim_to_align=False, mesh=mesh))
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
                              bg_token_mask: Optional[torch.Tensor] = None, mesh=None):
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
                                           do_demean_first=True, ref_grad_scale=1.0,
                                           mesh=mesh))
    return normalized_sum(l_fg), normalized_sum(l_bg)


def embedding_norm_loss(emb: torch.Tensor, target_norm: float = 1.0) -> torch.Tensor:
    """Keep subject embedding norms near `target_norm` (eps inside the
    sqrt keeps the gradient finite at zero embeddings)."""
    norms = torch.sqrt(torch.sum(torch.square(emb.float()), dim=-1) + 1e-12)
    return torch.mean(torch.square(norms - target_norm))


def delta_alignment_loss(feat_base, feat_ex, ref_feat_base, ref_feat_ex,
                         ref_grad_scale: float = 0.1, feat_base_grad_scale: float = 0.05,
                         cosine_exponent: float = 2.0,
                         delta_types=("feat_to_ref", "ex_to_base")) -> dict:
    """Delta alignment of (base -> extended) feature pairs to their reference
    pair, per delta type; channels last, leading dims are the batch."""
    if feat_base_grad_scale == -1:
        feat_base_grad_scale = min(ref_grad_scale / 2, 1.0)
    ref_base = grad_scale(ref_feat_base, ref_grad_scale)
    ref_ex = grad_scale(ref_feat_ex, ref_grad_scale)
    base = grad_scale(feat_base, feat_base_grad_scale)
    out = {}
    for t in delta_types:
        if t == "feat_to_ref":
            src, tgt = ortho_subtract(base, ref_base), ortho_subtract(feat_ex, ref_ex)
        elif t == "ex_to_base":
            src, tgt = ortho_subtract(ref_ex, ref_base), ortho_subtract(feat_ex, base)
        else:
            raise ValueError(t)
        out[t] = ref_cosine_loss(tgt, src, exponent=cosine_exponent, do_demean_first=False,
                                 ref_grad_scale=1.0)
    return out


def ortho_l2loss(a: torch.Tensor, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """MSE of the ortho residual of a against b (a batch mean)."""
    r = ortho_subtract(a, b)
    return _gmean(r * r, mesh)


def dyn_loss_scale(loss: torch.Tensor, loss_base: float, loss_scale_base: float,
                   min_scale_base_ratio: float = 1.0,
                   max_scale_base_ratio: float = 2.0) -> torch.Tensor:
    """`calc_dyn_loss_scale` on a tensor: the loss is read detached."""
    if loss_base == 0:
        return torch.zeros((), device=loss.device)
    s = loss.detach() * loss_scale_base / loss_base
    return torch.clamp(s, loss_scale_base * min_scale_base_ratio,
                       loss_scale_base * max_scale_base_ratio)


def convert_attn_to_spatial_weight(flat_attn: torch.Tensor, out_hw,
                                   reverse: bool = True) -> torch.Tensor:
    """[B, h, Q] summed subject attention (detached) -> [B, H, W, 1] spatial
    weight: head mean on its own square grid, resized to `out_hw`,
    normalized by the per-instance mean and std (ddof 1, floored at mean/2),
    exp(-x) when `reverse`, clamped at 1, renormalized to a unit mean."""
    a = flat_attn.detach().float()
    B = a.shape[0]
    s = int(round(a.shape[-1] ** 0.5))
    if s * s != a.shape[-1]:
        raise ValueError(f"non-square attention grid: Q={a.shape[-1]}")
    attn = resize_aa(a.mean(dim=1).reshape(B, s, s), out_hw[0], out_hw[1])[..., None]
    mean = attn.mean(dim=(1, 2), keepdim=True)
    std = attn.std(dim=(1, 2), keepdim=True, correction=1)
    denom = torch.maximum(std + 0.001, mean / 2)
    sign = -1.0 if reverse else 1.0
    w = torch.clamp_max(torch.exp(sign * (attn - mean) / denom), 1.0)
    return w / w.mean(dim=(1, 2), keepdim=True)


# 8/16 px feature maps pool 4-stride-2; 32/64 px pool 8-stride-4
FEAT_SIZE2POOLER_SPEC = {8: (4, 2), 16: (4, 2), 32: (8, 4), 64: (8, 4)}


def _avg_pool_nc(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """[B, C, H, W] average pool, no padding."""
    return torch.nn.functional.avg_pool2d(x, k, s)


def prompt_mix_layer_losses(outfeat: torch.Tensor, subj_attn: torch.Tensor, mesh=None):
    """One layer of the prompt-mix distillation over the 4-type batch
    (order subj_single, subj_comp, mix_single, mix_comp). outfeat
    [4B, H, W, C], subj_attn [4B, h, Q] (scores summed over the subject's
    slots). Returns (feat_delta_align, subj_attn_delta_align,
    subj_attn_norm): per-head ortho attention deltas (mix side 0.05
    gradient-scaled) cosine-aligned at exponent 3; L1 of the spatial-mean
    attention, subject vs mix rows; the outfeat reweighted by the reversed
    attention weights of mix_comp and subj_comp, pooled by
    `FEAT_SIZE2POOLER_SPEC` (a strict lookup), ortho deltas with 0.1
    gradient-scaled mix halves, MSE of the comp delta's residual against
    the single delta."""
    B = outfeat.shape[0] // 4
    ss_a, sc_a, ms_a, mc_a = subj_attn.reshape(4, B, *subj_attn.shape[1:]).unbind(0)
    mix_attn_gs = 0.05
    src = ortho_subtract(ss_a, grad_scale(ms_a, mix_attn_gs))
    tgt = ortho_subtract(sc_a, grad_scale(mc_a, mix_attn_gs))
    attn_delta = ref_cosine_loss(tgt, src, exponent=3.0, do_demean_first=False,
                                 ref_grad_scale=1.0, mesh=mesh)
    attn_norm = (_gmean(torch.abs(sc_a.mean(-1) - grad_scale(mc_a, mix_attn_gs).mean(-1)), mesh)
                 + _gmean(torch.abs(ss_a.mean(-1) - grad_scale(ms_a, mix_attn_gs).mean(-1)),
                          mesh))
    H, W, C = outfeat.shape[1:]
    sw = 0.5 * (convert_attn_to_spatial_weight(mc_a, (H, W))
                + convert_attn_to_spatial_weight(sc_a, (H, W)))  # [B, H, W, 1]
    f4 = outfeat.reshape(4, B, H, W, C) * sw[None]
    k, s = FEAT_SIZE2POOLER_SPEC[W]
    pooled = _avg_pool_nc(f4.reshape(4 * B, H, W, C).permute(0, 3, 1, 2), k, s)
    f2d = pooled.reshape(4, B, -1)
    comp_delta = ortho_subtract(f2d[1], grad_scale(f2d[3], 0.1))
    single_delta = ortho_subtract(f2d[0], grad_scale(f2d[2], 0.1))
    return ortho_l2loss(comp_delta, single_delta, mesh), attn_delta, attn_norm


def elastic_matching_loss(ca_q: torch.Tensor, ca_outfeat: torch.Tensor, fg_mask: torch.Tensor,
                          fg_bg_cutoff_prob: float = 0.25, single_q_grad_scale: float = 0.1,
                          single_feat_grad_scale: float = 0.01,
                          mix_feat_grad_scale: float = 0.05):
    """Cross-instance elastic feature matching of one block. ca_q, ca_outfeat
    [4, C, N] (order ss, sc, ms, mc); fg_mask [1, N] (the subj_single
    instance's fg at this resolution). The subj_comp tokens
    transport-reconstruct the subj_single fg features through a q-similarity
    softmax over the comp tokens; the sc->ss and mc->ms maps align on fg
    pairs; comp and mix features match on the soft background (comp tokens
    whose total fg-mapping probability is under the cutoff). Dense masks in
    place of gathered fg columns. Returns (map_align, sc_ss_fg_match,
    sc_mc_bg_match, (sc_bg_prob, mc_bg_prob))."""
    fg = fg_mask.float().reshape(1, -1)
    ss_q, sc_q, ms_q, mc_q = ca_q.split(1)
    sc_map_ss = torch.softmax(torch.einsum("bcn,bcm->bnm", sc_q,
                                           grad_scale(ss_q, single_q_grad_scale)), dim=1)
    mc_map_ms = torch.softmax(torch.einsum("bcn,bcm->bnm", mc_q,
                                           grad_scale(ms_q, single_q_grad_scale)), dim=1)
    ss_feat, sc_feat, ms_feat, mc_feat = ca_outfeat.split(1)
    sc_recon_ss = torch.einsum("bcn,bnm->bmc", sc_feat, sc_map_ss)  # [1, N, C]
    ss_feat_gs = grad_scale(ss_feat.transpose(1, 2), single_feat_grad_scale)
    fg_hw = fg[:, :, None] * fg[:, None, :]
    # one block: its reductions stay local
    loss_map_align = masked_mean(torch.abs(sc_map_ss - mc_map_ms), fg_hw)
    loss_sc_ss_fg_match = ref_cosine_loss(sc_recon_ss, ss_feat_gs, emb_weights=fg,
                                          exponent=2.0, do_demean_first=False,
                                          ref_grad_scale=1.0)
    sc_fg_prob = torch.einsum("bnm,bm->bn", sc_map_ss, fg)
    mc_fg_prob = torch.einsum("bnm,bm->bn", mc_map_ms, fg)
    sc_bg_prob = torch.clamp_min(fg_bg_cutoff_prob - sc_fg_prob, 0.0)
    mc_bg_prob = torch.clamp_min(fg_bg_cutoff_prob - mc_fg_prob, 0.0)
    loss_sc_mc_bg_match = ref_cosine_loss(
        sc_feat.transpose(1, 2), mc_feat.transpose(1, 2), emb_weights=mc_bg_prob,
        exponent=2.0, do_demean_first=False, ref_grad_scale=mix_feat_grad_scale)
    return loss_map_align, loss_sc_ss_fg_match, loss_sc_mc_bg_match, (sc_bg_prob, mc_bg_prob)


def _channel_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] normalized over channels by the population std (ddof 0,
    jnp's default; torch.std's is ddof 1), plus 1e-5."""
    mu = x.mean(dim=1, keepdim=True)
    return (x - mu) / (x.std(dim=1, keepdim=True, correction=0) + 1e-5)


def comp_fg_bg_preserve_loss(ca_outfeats: dict, ca_qs: dict, ca_attnscores: dict,
                             fg_mask: torch.Tensor, subj_token_mask: torch.Tensor,
                             pool_kernel: int = 4, pool_stride: int = 2,
                             mix_attn_grad_scale: float = 0.02, mesh=None):
    """The elastic-matching battery of each distillation layer over the
    4-type batch: outfeat [4B, H, W, C], q [4B, heads, N, d], attnscore
    [4B, heads, N, T]; fg_mask [B, H, W, 1] carries each block's own mask.
    The outfeat, LayerNormed over channels (population std), and the
    channel-folded q are avg-pooled above 8x8; each block matches against
    its own mask and the blocks average. The summed subject attention,
    resized to the pooled grid as `jax.image.resize` does (antialiased),
    is suppressed on the soft-background comp tokens (the mix rows 0.02
    gradient-scaled). Returns (map_align, sc_ss_fg_match, sc_mc_bg_match,
    subj_bg_attn_suppress, mix_bg_attn_suppress)."""
    weights = _normalize_weights(ATTN_ALIGN_LAYER_WEIGHTS)
    l_map, l_fg, l_bg, l_subj_sup, l_mix_sup = [], [], [], [], []
    for idx, outfeat in ca_outfeats.items():
        if idx not in weights or idx not in ca_qs:
            continue
        w = weights[idx]
        B4, H, W, C = outfeat.shape
        B = B4 // 4
        q = ca_qs[idx].float()
        qh = int(round(q.shape[2] ** 0.5))
        q_img = q.transpose(2, 3).reshape(B4, -1, qh, qh)
        feat_img = resize_aa(outfeat.float().permute(0, 3, 1, 2), qh, qh)
        feat_img = _channel_layer_norm(feat_img)
        if qh > 8:
            q_img = _avg_pool_nc(q_img, pool_kernel, pool_stride)
            feat_img = _avg_pool_nc(feat_img, pool_kernel, pool_stride)
        Np = q_img.shape[-2] * q_img.shape[-1]
        q_grp = q_img.reshape(4, B, q_img.shape[1], Np)
        feat_grp = feat_img.reshape(4, B, C, Np)
        fg_small = _resize_fg_mask_to_q(fg_mask, Np)  # [B, Np]
        per = [elastic_matching_loss(q_grp[:, b], feat_grp[:, b], fg_small[b:b + 1])
               for b in range(B)]
        l_map.append(w * _gmean(torch.stack([p[0] for p in per]), mesh))
        l_fg.append(w * _gmean(torch.stack([p[1] for p in per]), mesh))
        l_bg.append(w * _gmean(torch.stack([p[2] for p in per]), mesh))
        if idx in ca_attnscores:
            subj_attn = torch.einsum("bhnt,bt->bhn", ca_attnscores[idx].float(),
                                     subj_token_mask.float())
            n = subj_attn.shape[-1]
            if n != Np:
                s, ph2 = int(round(n ** 0.5)), int(round(Np ** 0.5))
                subj_attn = resize_aa(subj_attn.reshape(B4, -1, s, s), ph2, ph2)
                subj_attn = subj_attn.reshape(B4, -1, ph2 * ph2)
            a4 = subj_attn.reshape(4, B, *subj_attn.shape[1:])  # [4, B, h, Np]
            subj_pos = torch.clamp_min(a4[1], 0.0)
            mix_pos = torch.clamp_min(grad_scale(a4[3], mix_attn_grad_scale), 0.0)
            sc_bg = torch.stack([p[3][0] for p in per])  # [B, 1, Np]
            mc_bg = torch.stack([p[3][1] for p in per])
            l_subj_sup.append(w * masked_mean(subj_pos, sc_bg.expand(subj_pos.shape), mesh=mesh))
            l_mix_sup.append(w * masked_mean(mix_pos, mc_bg.expand(mix_pos.shape), mesh=mesh))
    return (normalized_sum(l_map), normalized_sum(l_fg), normalized_sum(l_bg),
            normalized_sum(l_subj_sup), normalized_sum(l_mix_sup))


def padding_embs_align_loss(prompt_embs: torch.Tensor, prompt_emb_mask: torch.Tensor,
                            subj_token_mask: torch.Tensor,
                            bg_token_mask: Optional[torch.Tensor] = None,
                            subj_contrast_paddings_grad_scale: float = 0.02,
                            subj_contrast_bg_grad_scale: float = 0.3, mesh=None):
    """Padding (and background) embeddings of [L, B, T, D] prompt embeddings
    pushed orthogonal to the summed subject embedding, each instance's
    weighted mean counting equally (off by default). Returns
    (padding_align, bg_subj_align)."""
    embs_f = prompt_embs.float()
    subj_sum = torch.einsum("lbtd,bt->bld", embs_f, subj_token_mask.float())
    pad_mask = 1.0 - prompt_emb_mask.float()
    pad_mask[:, 0] = 0.0
    embs = embs_f.permute(1, 2, 0, 3)  # [B, T, L, D]

    def contrast(token_mask, subj_grad_scale):
        subj = grad_scale(subj_sum, subj_grad_scale)
        return ref_cosine_loss(embs, subj[:, None], emb_weights=token_mask[:, :, None],
                               exponent=2.0, do_demean_first=True, ref_grad_scale=1.0,
                               aim_to_align=False, instance_axis=0, mesh=mesh)

    loss_pad = contrast(pad_mask, subj_contrast_paddings_grad_scale)
    loss_bg = (contrast(bg_token_mask.float(), subj_contrast_bg_grad_scale)
               if bg_token_mask is not None else torch.zeros((), device=prompt_embs.device))
    return loss_pad, loss_bg


# Per-layer weights of the subject/comp K/V orthogonality loss.
K_ORTHO_LAYER_WEIGHTS = {7: 0.5, 8: 0.5, 12: 1.0, 16: 1.0, 17: 1.0, 18: 1.0,
                         19: 1.0, 20: 1.0, 21: 1.0, 22: 1.0, 23: 1.0, 24: 1.0}
V_ORTHO_LAYER_WEIGHTS = {7: 0.5, 8: 0.5, 12: 1.0, 16: 1.0, 17: 1.0, 18: 0.5,
                         19: 0.5, 20: 0.5, 21: 0.25, 22: 0.25, 23: 0.25, 24: 0.25}


def normalized_ortho_subtract(a: torch.Tensor, b: torch.Tensor,
                              eps: float = 1e-6) -> torch.Tensor:
    """Both sides scaled to their mean norm before the ortho subtract; eps
    inside the sqrt keeps the gradient finite at a zero vector."""
    an = torch.sqrt(torch.sum(torch.square(a), dim=-1, keepdim=True) + eps * eps)
    bn = torch.sqrt(torch.sum(torch.square(b), dim=-1, keepdim=True) + eps * eps)
    mean2 = (an + bn) / 2.0
    return ortho_subtract(a * mean2 / an, b * mean2 / bn)


def _weighted_token_mean(seq: torch.Tensor, token_mask: torch.Tensor,
                         token_weights: torch.Tensor) -> torch.Tensor:
    """[H, T, D], [T], [T] -> [H, D]: the weight-scaled selected tokens
    summed, over the COUNT of selected tokens."""
    m = token_mask.float()
    return torch.einsum("t,htd->hd", m * token_weights, seq.float()) / (torch.sum(m) + 1e-8)


def comp_extra_token_mask(prompt_emb_mask: torch.Tensor, subj_token_mask: torch.Tensor,
                          bg_token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Real tokens that are neither subject nor background slots."""
    m = prompt_emb_mask.float() * (1.0 - subj_token_mask.float())
    if bg_token_mask is not None:
        m = m * (1.0 - bg_token_mask.float())
    return m


def subj_comp_ortho_loss(ca_ks: dict, ca_vs: dict, ca_attnscores: dict,
                         subj_comp_subj_mask: torch.Tensor,
                         subj_comp_extra_mask: torch.Tensor,
                         cls_comp_subj_mask: torch.Tensor,
                         cls_comp_extra_mask: torch.Tensor,
                         subj_block: int = 1, cls_block: int = 3,
                         cls_grad_scale: float = 0.05) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subject/comp K and V orthogonality alignment (off by default) over
    [4, H, T, Dh] keys and values of the 4-type batch: the attention-weighted
    mean K (V) of the subject tokens and of the comp-extra tokens,
    normalized-ortho-subtracted, for subj_comp and for cls_comp; the two
    differences cosine-aligned (margins 0.6 K, 0.7 V; the class side
    gradient-scaled; no gradient through the scores). Returns (loss_k,
    loss_v)."""
    kw = _normalize_weights({k: v for k, v in K_ORTHO_LAYER_WEIGHTS.items() if k in ca_ks})
    vw = _normalize_weights({k: v for k, v in V_ORTHO_LAYER_WEIGHTS.items() if k in ca_ks})
    dev = subj_comp_subj_mask.device
    loss_k = torch.zeros((), device=dev)
    loss_v = torch.zeros((), device=dev)

    def one(seq, scores, margin):
        w_subj = torch.clamp_min(scores[subj_block].mean(dim=(0, 1)), 0.0)
        w_cls = torch.clamp_min(scores[cls_block].mean(dim=(0, 1)), 0.0)
        subj_diff = normalized_ortho_subtract(
            _weighted_token_mean(seq[subj_block], subj_comp_subj_mask, w_subj),
            _weighted_token_mean(seq[subj_block], subj_comp_extra_mask, w_subj))
        cls_diff = normalized_ortho_subtract(
            _weighted_token_mean(seq[cls_block], cls_comp_subj_mask, w_cls),
            _weighted_token_mean(seq[cls_block], cls_comp_extra_mask, w_cls))
        return ref_cosine_loss(subj_diff, cls_diff, exponent=2.0, do_demean_first=False,
                               ref_grad_scale=cls_grad_scale, aim_to_align=True,
                               margin=margin)

    for layer in ca_ks:
        if layer not in kw:
            continue
        scores = ca_attnscores[layer].float().detach()
        loss_k = loss_k + kw[layer] * one(ca_ks[layer], scores, margin=0.6)
        loss_v = loss_v + vw[layer] * one(ca_vs[layer], scores, margin=0.7)
    return loss_k, loss_v
