"""The recon and compositional-distillation training steps (counterpart of
those parts of `adaface_tpu/training/train_step.py`).

Only the personalization parameters train: the static embedders' leaves
(all five, `pre_vecs` included, as JAX differentiates the whole pytree)
take gradients; CLIP, the UNet and the VAE are frozen. One step: encode the
prompt batch with the subject embeddings patched in, noise the latents at
the host-sampled timesteps, predict eps (with the cross-attention scores of
the distillation layers captured when the complementary battery is on),
sum the recon battery, backpropagate, and hand the gradients to the
optimizer chain (`training/prodigy.py`).

The compositional step encodes the 4-type prompt block (subj_single,
subj_comp, cls_single, cls_comp), spreads the class word over the subject's
pad slots in the class rows, mixes the class rows into V/K teacher contexts
(`training/mixing.py`, optionally compel-weighted, `ops/compel.py`), runs
one UNet call over (subj_single, subj_comp, mix_single, mix_comp) with the
distillation layers' outfeat, scores and q captured, and sums the
distillation battery.

The zero-shot steps train the SubjBasisGenerators instead of static
embedders: the frozen Arc2Face encoder turns the batch's identity
embeddings into the 16 core embeddings, each placeholder's generator maps
them (the bg one: the masked CLIP bg features) to [L, B, K, D] subject
embeddings, which are patched into the prompt as above; the recon battery
or, on a compositional iteration, the distillation battery follows (the
subj-single block's embeddings blended with those of a frozen copy of the
generators taken at setup). The bg generator's attention dropout is drawn
from the batch's `dropout_seed`, one stream per generator.

The Arc2Face distillation steps run a frozen teacher UNet over an S-step
trajectory (earlier timesteps drawn in [t 0.5^k, t 0.7^k], k = (S-1)^-0.3)
and make the student match its eps predictions at the trailing
max(7 // B, 1) steps, the losses summed and divided by sqrt(S); the
student's context comes from the static embedders or, zero-shot, from the
generators on the same identity that conditions the teacher.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from adaface_tpu_torch.data.tokenizer import CLIP_VOCAB_SIZE
from adaface_tpu_torch.models.unet import DISTILL_LAYER_INDICES
from adaface_tpu_torch.ops.compel import apply_compel_cfg
from adaface_tpu_torch.ops.grad import add_noise_to_tensor
from adaface_tpu_torch.personalization.arc2face import forward_face_embs
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.personalization.static_embedding import compute_static_embedding
from adaface_tpu_torch.personalization.subj_basis_generator import dropout_stream
from adaface_tpu_torch.training.losses import (
    ATTN_ALIGN_LAYER_WEIGHTS,
    _normalize_weights,
    comp_extra_token_mask,
    comp_fg_bg_preserve_loss,
    dyn_loss_scale,
    embedding_norm_loss,
    fg_bg_complementary_loss,
    fg_bg_xlayer_consist_loss,
    fg_mb_suppress_loss,
    masked_recon_loss,
    normalized_sum,
    padding_embs_align_loss,
    prompt_delta_loss,
    prompt_mix_layer_losses,
    subj_comp_ortho_loss,
)
from adaface_tpu_torch.training.mixing import mix_static_vk_embeddings

BOS_ID, EOS_ID = CLIP_VOCAB_SIZE - 2, CLIP_VOCAB_SIZE - 1
# the frozen generators' share of a zero-shot compos iteration's subj-single
# block
FROZEN_BLEND = 0.9
# an Arc2Face iteration's student matches the last max(7 // B, 1) of the
# teacher's steps
MAX_ACCUMU_BATCH = 7


def _prompt_emb_mask(ids: torch.Tensor) -> torch.Tensor:
    """[B, T] real-token mask: not BOS, not EOS/padding."""
    return ((ids != BOS_ID) & (ids != EOS_ID)).float()


def _iter_skip_weights(batch, skip_weights):
    """The batch's per-iteration clip-skip weights (a Dirichlet draw on the
    host), else the configured constant."""
    sw = getattr(batch, "skip_weights", None)
    return skip_weights if sw is None else sw


class ReconBatch(NamedTuple):
    """One recon iteration's batch, prepared on the host (latent space)."""

    latents: torch.Tensor  # [B, h, w, 4] VAE mean * scale factor
    token_ids: np.ndarray  # [B, 77]
    slot_maps: Dict[str, np.ndarray]  # placeholder -> [B, 77]
    fg_mask: Optional[torch.Tensor]  # [B, h, w, 1]
    timesteps: torch.Tensor  # [B]
    noise: torch.Tensor  # [B, h, w, 4]
    img_mask: Optional[torch.Tensor] = None  # [B, h, w, 1] augmentation valid area
    have_fg_mask: Optional[torch.Tensor] = None  # [B] 1 where the fg mask is real
    # annealed embedding noise: relative std (None or 0 disables) and the
    # seed of the torch.Generator that draws it, one draw per placeholder
    # in sorted order
    emb_noise_std: Optional[float] = None
    emb_noise_seed: Optional[int] = None
    # the 4-type delta-prompt battery of the static prompt-delta regularizer
    delta_token_ids: Optional[np.ndarray] = None  # [4B, T]
    delta_slot_maps: Optional[Dict[str, np.ndarray]] = None
    skip_weights: Optional[torch.Tensor] = None  # [2] per-iteration clip skip


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device)


def _subject_embeddings(embedders, batch, device) -> Dict[str, torch.Tensor]:
    """The embedders' [L, K, D] subject embeddings, with the batch's
    annealed noise (`_with_emb_noise`)."""
    return _with_emb_noise({s: compute_static_embedding(p) for s, p in embedders.items()},
                           batch, device)


def _with_emb_noise(subj: Dict[str, torch.Tensor], batch, device) -> Dict[str, torch.Tensor]:
    """The subject embeddings with the batch's annealed noise when it
    carries one: one draw per placeholder in sorted order from a
    torch.Generator seeded with `emb_noise_seed`."""
    if batch.emb_noise_std and batch.emb_noise_seed is not None:
        gen = torch.Generator(device=device).manual_seed(int(batch.emb_noise_seed))
        subj = {s: add_noise_to_tensor(e, batch.emb_noise_std, generator=gen)
                for s, e in sorted(subj.items())}
    return subj


def _encode_patched(clip, batch, subj, skip_weights) -> torch.Tensor:
    """The batch's prompts with the subject embeddings patched in, through
    CLIP: [L, B, T, D]."""
    dev = clip.token_embedding.weight.device
    patched = EmbeddingManager.patch_prompt_embeddings(
        clip.embed_tokens(_ids(batch.token_ids, dev)), batch.slot_maps, subj)
    L, B, T, D = patched.shape
    return clip(input_embeds=patched.reshape(L * B, T, D),
                skip_weights=_iter_skip_weights(batch, skip_weights)).reshape(L, B, T, D)


def _recon_prompt_delta(clip, batch: ReconBatch, subj: Dict[str, torch.Tensor],
                        skip_weights) -> torch.Tensor:
    """The static prompt-delta regularizer on a recon iteration: encode the
    4-type battery with the same subject embeddings as the recon pass,
    spread the class word over the pad slots of the class prompts, and align
    the ortho-subtracted comp-single deltas."""
    dev = clip.token_embedding.weight.device
    ids = _ids(batch.delta_token_ids, dev)
    patched = EmbeddingManager.patch_prompt_embeddings(
        clip.embed_tokens(ids), batch.delta_slot_maps, subj)
    L, B4, T, D = patched.shape
    ctx = clip(input_embeds=patched.reshape(L * B4, T, D),
               skip_weights=_iter_skip_weights(batch, skip_weights)).reshape(L, B4, T, D)
    B = B4 // 4
    ss, sc = ctx[:, :B], ctx[:, B:2 * B]
    cs, cc = ctx[:, 2 * B:3 * B], ctx[:, 3 * B:]
    for s in sorted(batch.delta_slot_maps):
        sm1b = np.asarray(batch.delta_slot_maps[s])[:B]
        cs = EmbeddingManager.distribute_cls_embeddings(cs, sm1b)
        cc = EmbeddingManager.distribute_cls_embeddings(cc, sm1b)
    return prompt_delta_loss(ss, sc, cs, cc, _prompt_emb_mask(ids[:B]),
                             _prompt_emb_mask(ids[B:2 * B]))


def _slot_union_mask(slot_maps: Dict[str, np.ndarray], keys, device) -> Optional[torch.Tensor]:
    """[B, T] float: 1 where any of the given placeholders has a slot."""
    masks = [torch.as_tensor(np.asarray(slot_maps[k]) >= 0, device=device).float()
             for k in keys]
    if not masks:
        return None
    return torch.clamp(sum(masks), 0.0, 1.0)


def _recon_complem_terms(aux: dict, slot_maps: Dict[str, np.ndarray],
                         fg_mask: Optional[torch.Tensor], bg_placeholders: frozenset,
                         use_bg_token: bool, do_zero_shot: bool, complem_weight: float,
                         xlayer_weight: float,
                         instance_mask: Optional[torch.Tensor] = None):
    """The recon iteration's attention battery on the captured scores:
    with a background token the complementary loss and its three
    suppressions (the complementary term x0.2 in zero-shot mode), without
    one the subject fg/bg suppression only; and the cross-layer consistency
    (zero-shot scales 0.2/0.06, else 1.0/0.3). Returns (loss, metrics). The
    fg vs webdataset-extra variant comes with the webdataset compositor."""
    scores = {i: aux[i]["attnscore"] for i in aux if "attnscore" in aux[i]}
    dev = next(iter(scores.values())).device
    subj_keys = sorted(k for k in slot_maps if k not in bg_placeholders)
    bg_keys = sorted(k for k in slot_maps if k in bg_placeholders)
    subj_mask = _slot_union_mask(slot_maps, subj_keys, dev)
    bg_mask = _slot_union_mask(slot_maps, bg_keys, dev) if use_bg_token else None

    loss = torch.zeros((), device=dev)
    metrics = {}
    if complem_weight > 0 and fg_mask is not None:
        if bg_mask is not None:
            comple, subj_mb, bg_mf, contrast = fg_bg_complementary_loss(
                scores, subj_mask, bg_mask, fg_mask, fg_grad_scale=0.1,
                instance_mask=instance_mask)
            comple_scale = 0.2 if do_zero_shot else 1.0
            loss = loss + (comple * comple_scale + subj_mb + bg_mf + contrast) * complem_weight
            metrics.update(fg_bg_complem=comple, subj_mb_suppress=subj_mb,
                           bg_mf_suppress=bg_mf, fg_bg_mask_contrast=contrast)
        else:
            subj_mb = fg_mb_suppress_loss(scores, subj_mask, fg_mask,
                                          instance_mask=instance_mask)
            loss = loss + subj_mb * complem_weight
            metrics.update(subj_mb_suppress=subj_mb)
    if xlayer_weight > 0:
        fg_x, bg_x = fg_bg_xlayer_consist_loss(scores, subj_mask, bg_mask)
        fg_scale = 0.2 if do_zero_shot else 1.0
        bg_scale = 0.06 if do_zero_shot else 0.3
        loss = loss + (fg_x * fg_scale + bg_x * bg_scale) * xlayer_weight
        metrics.update(fg_xlayer_consist=fg_x, bg_xlayer_consist=bg_x)
    return loss, metrics


def make_recon_train_step(clip, unet, sched, optimizer=None, skip_weights=(0.5, 0.5),
                          bg_weight: float = 0.1, emb_reg_weight: float = 2e-4,
                          complem_weight: float = 0.0, xlayer_weight: float = 0.0,
                          prompt_delta_weight: float = 0.0, use_bg_token: bool = False,
                          do_zero_shot: bool = True,
                          bg_placeholders: frozenset = frozenset()):
    """Returns `step(embedders, batch) -> metrics`, closing over the frozen
    CLIP and UNet and the optimizer chain: loss, backward, optimizer step.
    `step.loss_fn(embedders, batch) -> (loss, metrics)` is the loss alone.
    With complem/xlayer weights > 0 the UNet captures the distillation
    layers' cross-attention scores for the complementary battery."""
    do_capture = complem_weight > 0 or xlayer_weight > 0

    def loss_fn(embedders, batch: ReconBatch):
        subj = _subject_embeddings(embedders, batch, clip.token_embedding.weight.device)
        ctx = _encode_patched(clip, batch, subj, skip_weights)
        x_noisy = sched.q_sample(batch.latents, batch.timesteps, batch.noise)
        if do_capture:
            # the battery reads only attnscore; capturing the rest would
            # keep more activations alive through the backward pass
            eps, aux = unet(x_noisy, batch.timesteps, ctx, capture=True,
                            img_mask=batch.img_mask, capture_keys=("attnscore",))
        else:
            eps, aux = unet(x_noisy, batch.timesteps, ctx, img_mask=batch.img_mask), None
        recon = masked_recon_loss(eps, batch.noise, batch.fg_mask, bg_weight=bg_weight,
                                  img_mask=batch.img_mask)
        reg = sum(embedding_norm_loss(e) for e in subj.values()) / max(len(subj), 1)
        loss = recon + emb_reg_weight * reg
        metrics = {"recon": recon, "emb_reg": reg}
        if prompt_delta_weight > 0 and batch.delta_token_ids is not None:
            loss_delta = _recon_prompt_delta(clip, batch, subj, skip_weights)
            loss = loss + prompt_delta_weight * loss_delta
            metrics["prompt_delta"] = loss_delta
        if do_capture:
            complem, cm = _recon_complem_terms(
                aux, batch.slot_maps, batch.fg_mask, bg_placeholders, use_bg_token,
                do_zero_shot, complem_weight, xlayer_weight,
                instance_mask=batch.have_fg_mask)
            loss = loss + complem
            metrics.update(cm)
        metrics["loss"] = loss
        return loss, metrics

    return _with_optimizer(loss_fn, optimizer)


def _with_optimizer(loss_fn, optimizer):
    """`step(embedders, batch) -> metrics`: loss, backward, optimizer step;
    `step.loss_fn` is the loss alone."""

    def step(embedders, batch):
        loss, metrics = loss_fn(embedders, batch)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    step.loss_fn = loss_fn
    return step


class ComposBatch(NamedTuple):
    """One compositional-distillation iteration: the 4-type prompt batch
    with B blocks per type, order [subj_single, subj_comp, cls_single,
    cls_comp], prepared on the host."""

    token_ids: np.ndarray  # [4B, T]
    slot_maps: Dict[str, np.ndarray]  # placeholder -> [4B, T] (-1 on class rows)
    subj_slot_map: np.ndarray  # [4B, T] the foreground subject's slot map, by name
    latents: torch.Tensor  # [B, h, w, 4] x_start (fg-initialized, reused or noise)
    fg_mask: Optional[torch.Tensor]  # [B, h, w, 1]
    timesteps: torch.Tensor  # [B]
    noise: torch.Tensor  # [B, h, w, 4]
    t_frac: torch.Tensor  # [B] timesteps / num_timesteps
    training_percent: float
    # compel weighting of the mixed contexts; level 0 leaves them as they are
    compel_level: float = 0.0
    compel_batch_mask: Optional[torch.Tensor] = None  # [4B] 1 = apply
    # annealed embedding noise, as in ReconBatch
    emb_noise_std: Optional[float] = None
    emb_noise_seed: Optional[int] = None
    # (k_lb, k_ub, v_lb, v_ub) class-mix scale ranges; None keeps the
    # mixing defaults
    cls_mix_ranges: Optional[tuple] = None
    skip_weights: Optional[torch.Tensor] = None  # [2] per-iteration clip skip
    # scale of the elastic-matching preserve battery: 0 unless x_start was
    # fg-initialized, 0.5 fresh, 0.25 on a reuse-init iteration; None = 0.5
    preserve_loss_scale: Optional[float] = None


def make_compos_distill_step(clip, unet, sched, optimizer=None, skip_weights=(0.5, 0.5),
                             prompt_delta_weight: float = 2e-4,
                             mix_prompt_distill_weight: float = 1e-4,
                             fg_bg_weight: float = 1.0,
                             comp_fg_bg_preserve_weight: float = 1e-3,
                             xlayer_weight: float = 5e-5, do_zero_shot: bool = True,
                             bg_placeholders: frozenset = frozenset(),
                             padding_embs_align_weight: float = 0.0,
                             subj_comp_ortho_weight: float = 0.0,
                             empty_ctx: Optional[torch.Tensor] = None):
    """Returns `step(embedders, batch) -> metrics` of a compositional
    iteration, closing over the frozen CLIP and UNet and the optimizer
    chain; `step.loss_fn(embedders, batch) -> (loss, metrics)` is the loss
    alone. `empty_ctx` (the empty prompt's first-layer context) turns on
    the compel weighting of the V and K contexts. The padding-alignment and
    subject/comp orthogonality regularizers run when their weights are > 0
    (the latter captures the keys and values too)."""
    core = _make_compos_loss_core(
        clip, unet, sched, skip_weights, prompt_delta_weight, mix_prompt_distill_weight,
        fg_bg_weight, comp_fg_bg_preserve_weight, xlayer_weight, do_zero_shot,
        bg_placeholders, padding_embs_align_weight, subj_comp_ortho_weight, empty_ctx)

    def loss_fn(embedders, batch: ComposBatch):
        dev = clip.token_embedding.weight.device
        embedded = clip.embed_tokens(_ids(batch.token_ids, dev))
        subj = _subject_embeddings(embedders, batch, dev)
        return core(EmbeddingManager.patch_prompt_embeddings(embedded, batch.slot_maps, subj),
                    batch)

    return _with_optimizer(loss_fn, optimizer)


def _make_compos_loss_core(clip, unet, sched, skip_weights, prompt_delta_weight,
                           mix_prompt_distill_weight, fg_bg_weight,
                           comp_fg_bg_preserve_weight, xlayer_weight, do_zero_shot,
                           bg_placeholders, padding_embs_align_weight,
                           subj_comp_ortho_weight, empty_ctx):
    """The distillation battery over an already-patched [L, 4B, T, D]
    prompt-embedding batch."""

    def core(patched, batch: ComposBatch):
        L, B4, T, D = patched.shape
        dev = patched.device
        zero = torch.zeros((), device=dev)
        ctx = clip(input_embeds=patched.reshape(L * B4, T, D),
                   skip_weights=_iter_skip_weights(batch, skip_weights)).reshape(L, B4, T, D)
        B = B4 // 4
        subj_single, subj_comp = ctx[:, :B], ctx[:, B:2 * B]
        cls_single, cls_comp = ctx[:, 2 * B:3 * B], ctx[:, 3 * B:]
        # the class word over the subject's pad slots in the class rows, by
        # the subj_single block's slot maps (the 4 prompt types are
        # prefix-aligned)
        for s in sorted(batch.slot_maps):
            sm1b = np.asarray(batch.slot_maps[s])[:B]
            cls_single = EmbeddingManager.distribute_cls_embeddings(cls_single, sm1b)
            cls_comp = EmbeddingManager.distribute_cls_embeddings(cls_comp, sm1b)

        ids = _ids(batch.token_ids, dev)
        single_mask = _prompt_emb_mask(ids[:B])
        comp_mask = _prompt_emb_mask(ids[B:2 * B])
        loss_delta = prompt_delta_loss(subj_single, subj_comp, cls_single, cls_comp,
                                       single_mask, comp_mask)

        first = torch.as_tensor(np.asarray(batch.subj_slot_map), device=dev)
        subj_tok_single = (first[:B] >= 0).float()
        subj_tok_comp = (first[B:2 * B] >= 0).float()
        mix_kw = {}
        if batch.cls_mix_ranges is not None:
            r = batch.cls_mix_ranges
            mix_kw = dict(k_cls_scale_range=(r[0], r[1]), v_cls_scale_range=(r[2], r[3]))
        s_vk_single, m_vk_single = mix_static_vk_embeddings(
            subj_single, cls_single, subj_tok_single, batch.training_percent, batch.t_frac,
            **mix_kw)
        s_vk_comp, m_vk_comp = mix_static_vk_embeddings(
            subj_comp, cls_comp, subj_tok_comp, batch.training_percent, batch.t_frac,
            **mix_kw)
        ctx_vk = torch.cat([s_vk_single, s_vk_comp, m_vk_single, m_vk_comp], dim=1)
        ctx_v, ctx_k = ctx_vk[:, :, :T], ctx_vk[:, :, T:]
        if empty_ctx is not None:
            # V and K weighted separately around the empty prompt's context
            empty = empty_ctx.to(ctx_v.dtype)
            ctx_v = apply_compel_cfg(ctx_v, empty, batch.compel_level,
                                     batch_mask=batch.compel_batch_mask)
            ctx_k = apply_compel_cfg(ctx_k, empty, batch.compel_level,
                                     batch_mask=batch.compel_batch_mask)
        t4 = batch.timesteps.repeat(4)
        x_noisy = sched.q_sample(batch.latents.repeat(4, 1, 1, 1), t4,
                                 batch.noise.repeat(4, 1, 1, 1))
        cap_keys = ("outfeat", "attnscore", "q")
        if subj_comp_ortho_weight > 0:
            cap_keys = cap_keys + ("k", "v")
        _, aux = unet(x_noisy, t4, ctx_v, context_k=ctx_k, capture=True,
                      capture_keys=cap_keys)

        # prompt-mix feature / attention delta alignment and attention norm
        # distillation; the mix rows carry the (mixed) subject embeddings at
        # the subject rows' slot positions
        layer_w = _normalize_weights(ATTN_ALIGN_LAYER_WEIGHTS)
        subj_mask4 = torch.cat([subj_tok_single, subj_tok_comp, subj_tok_single,
                                subj_tok_comp], dim=0)
        l_feat, l_attn, l_attn_norm = [], [], []
        for idx in DISTILL_LAYER_INDICES:
            if idx not in aux or idx not in layer_w:
                continue
            subj_attn = torch.einsum("bhqt,bt->bhq", aux[idx]["attnscore"].float(), subj_mask4)
            fd, ad, an = prompt_mix_layer_losses(aux[idx]["outfeat"], subj_attn)
            l_feat.append(layer_w[idx] * fd)
            l_attn.append(layer_w[idx] * ad)
            l_attn_norm.append(layer_w[idx] * an)
        loss_feat = normalized_sum(l_feat)
        loss_attn = normalized_sum(l_attn)
        loss_attn_norm = normalized_sum(l_attn_norm)

        bg_keys = sorted(k for k in batch.slot_maps if k in bg_placeholders)
        bg_mask2 = _slot_union_mask({k: np.asarray(batch.slot_maps[k])[:2 * B] for k in bg_keys},
                                    bg_keys, dev)
        subj_mask2 = torch.cat([subj_tok_single, subj_tok_comp], dim=0)
        # cross-layer attention consistency over the subject rows
        loss_xlayer = zero
        if xlayer_weight > 0:
            subj_scores = {i: aux[i]["attnscore"][:2 * B] for i in aux if "attnscore" in aux[i]}
            fg_x, bg_x = fg_bg_xlayer_consist_loss(subj_scores, subj_mask2, bg_mask2)
            fg_scale = 0.2 if do_zero_shot else 1.0
            bg_scale = 0.06 if do_zero_shot else 0.3
            if bg_mask2 is not None:
                # no bg token in this iteration's prompts: an empty mask
                bg_x = bg_x * torch.clamp(torch.sum(bg_mask2), 0.0, 1.0)
            loss_xlayer = fg_x * fg_scale + bg_x * bg_scale

        loss_fg_bg = zero
        loss_preserve = zero
        if batch.fg_mask is not None:
            scores_first = {i: aux[i]["attnscore"][:B] for i in aux if "attnscore" in aux[i]}
            loss_fg_bg = fg_mb_suppress_loss(scores_first, subj_tok_single, batch.fg_mask)
            p_map, p_fg, p_bg, p_subj_sup, p_mix_sup = comp_fg_bg_preserve_loss(
                {i: aux[i]["outfeat"] for i in aux}, {i: aux[i]["q"] for i in aux},
                {i: aux[i]["attnscore"] for i in aux}, batch.fg_mask, subj_mask4)
            loss_preserve = (p_map + p_fg + p_bg * dyn_loss_scale(p_bg, 0.2, 2.0, 1.0, 3.0)
                             + (p_subj_sup + p_mix_sup) * 0.02)

        loss_pad_align = zero
        if padding_embs_align_weight > 0:
            lp, lb = padding_embs_align_loss(ctx[:, :2 * B],
                                             torch.cat([single_mask, comp_mask], dim=0),
                                             subj_mask2, bg_mask2)
            loss_pad_align = lp + lb
        loss_ortho_k = loss_ortho_v = zero
        if subj_comp_ortho_weight > 0:
            # block 0 of each prompt type; the class rows carry the class
            # embedding at the subject's slot positions
            sel = [0, B, 2 * B, 3 * B]
            loss_ortho_k, loss_ortho_v = subj_comp_ortho_loss(
                {i: aux[i]["k"][sel] for i in aux}, {i: aux[i]["v"][sel] for i in aux},
                {i: aux[i]["attnscore"][sel] for i in aux},
                subj_comp_subj_mask=subj_tok_comp[0],
                subj_comp_extra_mask=comp_extra_token_mask(comp_mask[0], subj_tok_comp[0]),
                cls_comp_subj_mask=subj_tok_comp[0],
                cls_comp_extra_mask=comp_extra_token_mask(
                    _prompt_emb_mask(ids[3 * B:3 * B + 1])[0], subj_tok_comp[0]))

        attn_norm_scale = 1.0 if do_zero_shot else dyn_loss_scale(loss_attn_norm, 5.0, 0.2)
        loss_mix_distill = (loss_attn * 0.1 + loss_attn_norm * attn_norm_scale
                            + loss_feat * (0.5 if do_zero_shot else 2.0))
        preserve_scale = (0.5 if batch.preserve_loss_scale is None
                          else float(batch.preserve_loss_scale))
        # the preserve battery, when it contributes, halves the mix distillation
        mix_scale = 1.0
        if batch.fg_mask is not None:
            mix_scale = torch.where((preserve_scale * loss_preserve).detach() > 0, 0.5, 1.0)
        loss = (prompt_delta_weight * loss_delta
                + mix_prompt_distill_weight * mix_scale * loss_mix_distill
                + fg_bg_weight * loss_fg_bg
                + comp_fg_bg_preserve_weight * preserve_scale * loss_preserve
                + xlayer_weight * loss_xlayer
                + padding_embs_align_weight * loss_pad_align
                + subj_comp_ortho_weight * (loss_ortho_k + loss_ortho_v))
        metrics = {"loss": loss, "prompt_delta": loss_delta, "feat_align": loss_feat,
                   "attn_align": loss_attn, "attn_norm_distill": loss_attn_norm,
                   "mix_prompt_distill": loss_mix_distill, "fg_bg": loss_fg_bg,
                   "comp_fg_bg_preserve": loss_preserve, "xlayer_consist": loss_xlayer}
        if padding_embs_align_weight > 0:
            metrics["padding_embs_align"] = loss_pad_align
        if subj_comp_ortho_weight > 0:
            metrics["subj_comp_ortho_k"] = loss_ortho_k
            metrics["subj_comp_ortho_v"] = loss_ortho_v
        return loss, metrics

    return core


# ------------------------------------------------------------------ zero-shot
class ZeroShotTemplates(NamedTuple):
    """What the zero-shot steps need of the frozen Arc2Face encoder's
    prompts: [1, T] ids of the forward and inverse templates and the id of
    the word "id"."""

    forward_ids: np.ndarray
    inverse_ids: np.ndarray
    arcface_token_id: int


def _arc2face_core(arc2face_encoder, id_embs: torch.Tensor, templates: ZeroShotTemplates):
    """(full [B, T, D], core [B, 16, D]) Arc2Face forward embeddings of the
    identity embeddings; frozen, no gradient."""
    with torch.no_grad():
        return forward_face_embs(arc2face_encoder, id_embs.detach(), templates.forward_ids,
                                 templates.arcface_token_id)


def _generator_embeddings(generators: dict, batch, arc_id_embs: torch.Tensor,
                          bg_placeholders: frozenset,
                          templates: ZeroShotTemplates) -> Dict[str, torch.Tensor]:
    """placeholder -> [L, B, K, D]: each generator (sorted order, the i-th
    drawing its dropout from stream i of `batch.dropout_seed`) on the bg
    features (bg placeholders) or the Arc2Face core embeddings."""
    subj = {}
    dev = arc_id_embs.device
    for i, (s, gen) in enumerate(sorted(generators.items())):
        feats = batch.clip_bg if s in bg_placeholders else batch.clip_fg
        embs, _ = gen(feats, None, arc_id_embs, is_face=True, is_training=True,
                      inverse_template_ids=templates.inverse_ids,
                      dropout_generator=dropout_stream(batch.dropout_seed, i, dev))
        subj[s] = embs.transpose(0, 1)
    return subj


class ZeroShotReconBatch(NamedTuple):
    """One zero-shot recon iteration: a ReconBatch plus the subjects'
    identity evidence."""

    latents: torch.Tensor  # [B, h, w, 4]
    token_ids: np.ndarray  # [B, T]
    slot_maps: Dict[str, np.ndarray]
    fg_mask: Optional[torch.Tensor]  # [B, h, w, 1]
    timesteps: torch.Tensor  # [B]
    noise: torch.Tensor  # [B, h, w, 4]
    clip_fg: torch.Tensor  # [B, 257, D_img] masked CLIP fg features
    clip_bg: torch.Tensor  # [B, 257, D_img]
    id_embs: torch.Tensor  # [B, 512] identity embeddings
    emb_noise_std: Optional[float] = None
    emb_noise_seed: Optional[int] = None
    dropout_seed: Optional[int] = None  # the bg generator's attention dropout; None: off
    delta_token_ids: Optional[np.ndarray] = None  # [4B, T]
    delta_slot_maps: Optional[Dict[str, np.ndarray]] = None
    img_mask: Optional[torch.Tensor] = None  # [B, h, w, 1]
    have_fg_mask: Optional[torch.Tensor] = None  # [B]
    skip_weights: Optional[torch.Tensor] = None


def make_zero_shot_recon_step(clip, unet, sched, optimizer,
                              bg_placeholders: frozenset, arc2face_encoder,
                              templates: ZeroShotTemplates, skip_weights=(0.5, 0.5),
                              bg_weight: float = 0.1, complem_weight: float = 0.0, xlayer_weight: float = 0.0,
                              prompt_delta_weight: float = 0.0, use_bg_token: bool = False):
    """Returns `step(generators, batch) -> metrics` of a zero-shot recon
    iteration (identity -> frozen Arc2Face forward -> generators -> patched
    prompt -> eps recon, with the complementary battery when its weights
    are > 0); `step.loss_fn(generators, batch) -> (loss, metrics)`."""
    do_capture = complem_weight > 0 or xlayer_weight > 0

    def loss_fn(gens: dict, batch: ZeroShotReconBatch):
        dev = clip.token_embedding.weight.device
        _, arc_id_embs = _arc2face_core(arc2face_encoder, batch.id_embs, templates)
        subj = _with_emb_noise(
            _generator_embeddings(gens, batch, arc_id_embs, bg_placeholders, templates),
            batch, dev)
        ctx = _encode_patched(clip, batch, subj, skip_weights)
        x_noisy = sched.q_sample(batch.latents, batch.timesteps, batch.noise)
        if do_capture:
            eps, aux = unet(x_noisy, batch.timesteps, ctx, capture=True,
                            img_mask=batch.img_mask, capture_keys=("attnscore",))
        else:
            eps, aux = unet(x_noisy, batch.timesteps, ctx, img_mask=batch.img_mask), None
        recon = masked_recon_loss(eps, batch.noise, batch.fg_mask, bg_weight=bg_weight,
                                  img_mask=batch.img_mask)
        loss = recon
        metrics = {"recon": recon}
        if prompt_delta_weight > 0 and batch.delta_token_ids is not None:
            # per-instance embeddings; the 4-type battery repeats each instance
            subj4 = {s: torch.cat([v] * 4, dim=1) for s, v in subj.items()}
            loss_delta = _recon_prompt_delta(clip, batch, subj4, skip_weights)
            loss = loss + prompt_delta_weight * loss_delta
            metrics["prompt_delta"] = loss_delta
        if do_capture:
            complem, cm = _recon_complem_terms(
                aux, batch.slot_maps, batch.fg_mask, bg_placeholders, use_bg_token, True,
                complem_weight, xlayer_weight, instance_mask=batch.have_fg_mask)
            loss = loss + complem
            metrics.update(cm)
        metrics["loss"] = loss
        return loss, metrics

    return _with_optimizer(loss_fn, optimizer)


class ZeroShotComposBatch(NamedTuple):
    """A compositional iteration's 4-type prompt block (as ComposBatch)
    plus the identity evidence of its CB blocks (or of one shared subject)."""

    token_ids: np.ndarray  # [4B, T]
    slot_maps: Dict[str, np.ndarray]
    subj_slot_map: np.ndarray
    latents: torch.Tensor  # [B, h, w, 4]
    fg_mask: Optional[torch.Tensor]
    timesteps: torch.Tensor
    noise: torch.Tensor
    t_frac: torch.Tensor
    training_percent: float
    clip_fg: torch.Tensor  # [CB or 1, 257, D_img]
    clip_bg: torch.Tensor
    id_embs: torch.Tensor  # [CB or 1, 512]
    compel_level: float = 0.0
    compel_batch_mask: Optional[torch.Tensor] = None
    emb_noise_std: Optional[float] = None
    emb_noise_seed: Optional[int] = None
    dropout_seed: Optional[int] = None
    cls_mix_ranges: Optional[tuple] = None
    skip_weights: Optional[torch.Tensor] = None
    preserve_loss_scale: Optional[float] = None


def make_zero_shot_compos_step(clip, unet, sched, optimizer, frozen_generators: dict,
                               bg_placeholders: frozenset, arc2face_encoder, templates: ZeroShotTemplates,
                               skip_weights=(0.5, 0.5), prompt_delta_weight: float = 2e-4,
                               mix_prompt_distill_weight: float = 1e-4,
                               fg_bg_weight: float = 1.0,
                               comp_fg_bg_preserve_weight: float = 1e-3,
                               xlayer_weight: float = 5e-5):
    """Returns `step(generators, batch) -> metrics` of a zero-shot
    compositional iteration: the distillation battery of
    `make_compos_distill_step` (without the two regularizers that ship
    disabled) on generator embeddings, the subj-single block's taken as
    FROZEN_BLEND x the frozen copy's + (1 - FROZEN_BLEND) x the live
    generators' (the same dropout streams for both);
    `step.loss_fn(generators, batch)`."""
    core = _make_compos_loss_core(
        clip, unet, sched, skip_weights, prompt_delta_weight, mix_prompt_distill_weight,
        fg_bg_weight, comp_fg_bg_preserve_weight, xlayer_weight, True, bg_placeholders,
        0.0, 0.0, None)

    def loss_fn(gens: dict, batch: ZeroShotComposBatch):
        dev = clip.token_embedding.weight.device
        _, arc_id_embs = _arc2face_core(arc2face_encoder, batch.id_embs, templates)
        embs = lambda g: _generator_embeddings(g, batch, arc_id_embs, bg_placeholders,
                                               templates)
        live = embs(gens)
        with torch.no_grad():
            frozen = embs(frozen_generators)
        CB = len(batch.token_ids) // 4
        subj = {}
        for s in live:
            # [L, G, K, D]: G = CB block identities, or one shared identity
            lv, fr = live[s], frozen[s]
            if lv.shape[1] != CB:
                shape = (lv.shape[0], CB) + tuple(lv.shape[2:])
                lv, fr = lv.expand(shape), fr.expand(shape)
            single = FROZEN_BLEND * fr + (1 - FROZEN_BLEND) * lv
            # type-major rows; the class rows' slots are all -1
            subj[s] = torch.cat([single, lv, lv, lv], dim=1)
        subj = _with_emb_noise(subj, batch, dev)
        embedded = clip.embed_tokens(_ids(batch.token_ids, dev))
        return core(EmbeddingManager.patch_prompt_embeddings(embedded, batch.slot_maps, subj),
                    batch)

    return _with_optimizer(loss_fn, optimizer)


# --------------------------------------------------------- Arc2Face teacher
class Arc2FaceBatch(NamedTuple):
    """One Arc2Face distillation iteration of per-subject training."""

    latents: torch.Tensor  # [B, h, w, 4] x_start
    teacher_context: torch.Tensor  # [B, T_a, D] Arc2Face prompt embeddings
    token_ids: np.ndarray  # [B, T] the student's subject prompt
    slot_maps: Dict[str, np.ndarray]
    timesteps: torch.Tensor  # [B] the first step's t
    noises: torch.Tensor  # [S, B, h, w, 4] a noise per step
    relative_ts: torch.Tensor  # [max(S-1, 1), B] uniforms placing the earlier ts
    fg_mask: Optional[torch.Tensor]
    img_mask: Optional[torch.Tensor] = None  # None on a random-face iteration
    skip_weights: Optional[torch.Tensor] = None


class ZeroShotArc2FaceBatch(NamedTuple):
    """Arc2Face distillation of the generators: the teacher's context is
    the Arc2Face forward of `id_embs`, the student's the generators' output
    on the same identity."""

    latents: torch.Tensor
    token_ids: np.ndarray
    slot_maps: Dict[str, np.ndarray]
    timesteps: torch.Tensor
    noises: torch.Tensor
    relative_ts: torch.Tensor
    fg_mask: Optional[torch.Tensor]
    clip_fg: torch.Tensor  # [B, 257, D_img]
    clip_bg: torch.Tensor
    id_embs: torch.Tensor  # [B, 512]
    img_mask: Optional[torch.Tensor] = None
    dropout_seed: Optional[int] = None
    skip_weights: Optional[torch.Tensor] = None


@torch.no_grad()
def _teacher_trajectory(teacher_unet, sched, batch, teacher_context: torch.Tensor, S: int):
    """The frozen teacher over S denoising steps: (x_starts, ts,
    noise_preds), x_starts[i + 1] its x_0 estimate at step i, ts[i + 1]
    drawn in [ts[i] 0.5^k, ts[i] 0.7^k] by `relative_ts[i]`."""
    x_starts, ts, preds = [batch.latents], [batch.timesteps], []
    ctx = teacher_context[None].to(teacher_unet.in_conv.weight.dtype)
    for i in range(S):
        x_noisy = sched.q_sample(x_starts[i], ts[i], batch.noises[i])
        pred = teacher_unet(x_noisy, ts[i], ctx)
        preds.append(pred)
        x_starts.append(sched.predict_x0_from_eps(x_noisy, ts[i], pred))
        if i < S - 1:
            k = (S - 1) ** -0.3
            t = ts[i].float()
            lb = t * torch.tensor(0.5 ** k, dtype=torch.float32)
            ub = t * torch.tensor(0.7 ** k, dtype=torch.float32)
            ts.append(((ub - lb) * batch.relative_ts[i].float() + lb).to(torch.int32))
    return x_starts, ts, preds


def _student_loss(unet, sched, batch, ctx, trajectory, S: int, use_fg_mask: bool):
    """The student's eps against the teacher's at the trailing
    max(MAX_ACCUMU_BATCH // B, 1) steps, fg-masked with bg weight 0 unless
    `use_fg_mask` is off; summed / sqrt(S). Returns (loss, metrics)."""
    x_starts, ts, preds = trajectory
    B = batch.latents.shape[0]
    losses = []
    for s in range(max(0, S - max(MAX_ACCUMU_BATCH // B, 1)), S):
        x_noisy = sched.q_sample(x_starts[s], ts[s], batch.noises[s])
        student = unet(x_noisy, ts[s], ctx, img_mask=batch.img_mask)
        if use_fg_mask and batch.fg_mask is not None:
            losses.append(masked_recon_loss(student, preds[s], batch.fg_mask, bg_weight=0.0,
                                            img_mask=batch.img_mask))
        else:
            losses.append(torch.mean(torch.square(student.float() - preds[s].float())))
    loss = sum(losses) / float(np.sqrt(float(S)))
    return loss, {"loss": loss, "n_loss_steps": torch.tensor(float(len(losses)))}


def make_arc2face_distill_step(clip, unet, teacher_unet, sched, optimizer,
                               num_denoising_steps: int = 1, skip_weights=(0.5, 0.5),
                               use_fg_mask: bool = True):
    """Returns `step(embedders, batch) -> metrics` of an Arc2Face
    distillation iteration of per-subject training (`use_fg_mask` off on a
    random-face iteration); `step.loss_fn(embedders, batch)`."""
    S = num_denoising_steps

    def loss_fn(embedders, batch: Arc2FaceBatch):
        trajectory = _teacher_trajectory(teacher_unet, sched, batch, batch.teacher_context, S)
        subj = {s: compute_static_embedding(p) for s, p in embedders.items()}
        ctx = _encode_patched(clip, batch, subj, skip_weights)
        return _student_loss(unet, sched, batch, ctx, trajectory, S, use_fg_mask)

    return _with_optimizer(loss_fn, optimizer)


def make_zero_shot_arc2face_step(clip, unet, teacher_unet, sched, optimizer,
                                 bg_placeholders: frozenset, arc2face_encoder,
                                 templates: ZeroShotTemplates, num_denoising_steps: int = 1,
                                 skip_weights=(0.5, 0.5), use_fg_mask: bool = True):
    """Returns `step(generators, batch) -> metrics` of a zero-shot Arc2Face
    distillation iteration: one identity conditions the teacher (its
    Arc2Face forward context) and the generators; only the generators take
    gradients. `step.loss_fn(generators, batch)`."""
    S = num_denoising_steps

    def loss_fn(gens: dict, batch: ZeroShotArc2FaceBatch):
        full, arc_id_embs = _arc2face_core(arc2face_encoder, batch.id_embs, templates)
        trajectory = _teacher_trajectory(teacher_unet, sched, batch, full, S)
        subj = _generator_embeddings(gens, batch, arc_id_embs, bg_placeholders, templates)
        ctx = _encode_patched(clip, batch, subj, skip_weights)
        return _student_loss(unet, sched, batch, ctx, trajectory, S, use_fg_mask)

    return _with_optimizer(loss_fn, optimizer)
