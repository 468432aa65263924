"""The recon training step (counterpart of the recon part of
`adaface_tpu/training/train_step.py`).

Only the personalization parameters train: the static embedders' leaves
(all five, `pre_vecs` included, as JAX differentiates the whole pytree)
take gradients; CLIP, the UNet and the VAE are frozen. One step: encode the
prompt batch with the subject embeddings patched in, noise the latents at
the host-sampled timesteps, predict eps (with the cross-attention scores of
the distillation layers captured when the complementary battery is on),
sum the recon battery, backpropagate, and hand the gradients to the
optimizer chain (`training/prodigy.py`). The compositional and Arc2Face
distillation steps are not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from adaface_tpu_torch.data.tokenizer import CLIP_VOCAB_SIZE
from adaface_tpu_torch.ops.grad import add_noise_to_tensor
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.personalization.static_embedding import compute_static_embedding
from adaface_tpu_torch.training.losses import (
    embedding_norm_loss,
    fg_bg_complementary_loss,
    fg_bg_xlayer_consist_loss,
    fg_mb_suppress_loss,
    masked_recon_loss,
    prompt_delta_loss,
)

BOS_ID, EOS_ID = CLIP_VOCAB_SIZE - 2, CLIP_VOCAB_SIZE - 1


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
        dev = clip.token_embedding.weight.device
        embedded = clip.embed_tokens(_ids(batch.token_ids, dev))
        subj = {s: compute_static_embedding(p) for s, p in embedders.items()}
        if batch.emb_noise_std and batch.emb_noise_seed is not None:
            gen = torch.Generator(device=dev).manual_seed(int(batch.emb_noise_seed))
            subj = {s: add_noise_to_tensor(e, batch.emb_noise_std, generator=gen)
                    for s, e in sorted(subj.items())}
        patched = EmbeddingManager.patch_prompt_embeddings(embedded, batch.slot_maps, subj)
        L, B, T, D = patched.shape
        ctx = clip(input_embeds=patched.reshape(L * B, T, D),
                   skip_weights=_iter_skip_weights(batch, skip_weights)).reshape(L, B, T, D)
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

    def step(embedders, batch: ReconBatch):
        loss, metrics = loss_fn(embedders, batch)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    step.loss_fn = loss_fn
    return step
