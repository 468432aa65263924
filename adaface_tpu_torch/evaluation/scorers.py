"""Similarity scorers: CLIP-I / CLIP-T (ViT-B/32) and DINO (ViT-S/16)
(counterpart of `adaface_tpu/evaluation/scorers.py`).

`CLIPScorer` is the dual-tower contrastive model the reference scores with
(not SD's conditioning encoder): image features are the vision tower's
pooled output times the visual projection, text features the text tower's
final-LN state at the EOT row (`argmax(ids)`, OpenAI CLIP's convention) times
the text projection, both L2-normed. `DINOScorer` takes the ViT's CLS
feature, L2-normed. Similarities reduce as the reference's do: `mean`,
`diag`, `diagmean` or `none`.

`init_evaluators` builds the pair: real weights from HF-format state dicts
(`CLIP_SCORER_PT`: a whole `CLIPModel`; `DINO_VITS16_PT`: a `ViTModel`),
read without running pickled code; without files, random tiny towers (smoke
mode). The towers are plain PyTorch with einsum attention: no TPU kernel.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from adaface_tpu_torch.device import resolve_device
from adaface_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from adaface_tpu_torch.models.clip_vision import (
    CLIPVisionConfig,
    CLIPVisionEncoder,
    preprocess_images,
)
from adaface_tpu_torch.models.vit import ViTConfig, ViTEncoder, preprocess_vit_images


def _reduce(sim: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return sim.mean()
    if reduction == "diag":
        return torch.diagonal(sim)
    if reduction == "diagmean":
        return torch.diagonal(sim).mean()
    if reduction == "none":
        return sim
    raise NotImplementedError(reduction)


def _normed(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def clip_b32_text_config(**kw) -> CLIPTextConfig:
    """OpenAI ViT-B/32's text tower: 512 wide, 8 heads, 2048 MLP."""
    return CLIPTextConfig(hidden_size=512, num_heads=8, intermediate_size=2048, **kw)


class CLIPScorer:
    """Holds the towers (on their device, eval mode) and the projections
    ([D_tower, 512]; identity when None)."""

    def __init__(self, tokenizer, text: CLIPTextEncoder, vision: CLIPVisionEncoder,
                 text_projection: Optional[torch.Tensor] = None,
                 visual_projection: Optional[torch.Tensor] = None):
        self.tokenizer = tokenizer
        self.text = text.eval().requires_grad_(False)
        self.vision = vision.eval().requires_grad_(False)
        dev = self.vision.class_embedding.device
        proj = lambda p, d: (torch.eye(d, 512) if p is None
                             else torch.as_tensor(p)).float().to(dev)
        self.text_projection = proj(text_projection, self.text.cfg.hidden_size)
        self.visual_projection = proj(visual_projection, self.vision.cfg.hidden_size)

    @property
    def device(self) -> torch.device:
        return self.vision.class_embedding.device

    @torch.inference_mode()
    def get_image_features(self, images) -> torch.Tensor:
        """images [B, H, W, 3] uint8 or float in [0, 255] -> [B, D_joint]."""
        pixels = preprocess_images(torch.as_tensor(np.asarray(images)).to(self.device),
                                   self.vision.cfg.image_size)
        _, pooled, _ = self.vision(pixels)
        return _normed(pooled.float() @ self.visual_projection)

    @torch.inference_mode()
    def get_text_features(self, texts: Sequence[str]) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(self.tokenizer(list(texts))), dtype=torch.long,
                              device=self.device)
        seq = self.text(ids)
        pooled = seq[torch.arange(seq.shape[0], device=self.device), torch.argmax(ids, dim=-1)]
        return _normed(pooled.float() @ self.text_projection)

    def image_pairwise_similarity(self, images1, images2, reduction="mean"):
        return _reduce(self.get_image_features(images1) @ self.get_image_features(images2).T,
                       reduction)

    def txt_to_img_similarity(self, text, images, reduction="mean"):
        t = self.get_text_features([text] if isinstance(text, str) else text)
        return _reduce(t @ self.get_image_features(images).T, reduction)

    def text_pairwise_similarity(self, texts1, texts2, reduction="mean"):
        return _reduce(self.get_text_features(texts1) @ self.get_text_features(texts2).T,
                       reduction)

    def evaluate(self, gen_samples, ref_images, target_text):
        """(CLIP-I, CLIP-T) of generated samples against reference images
        and the target text."""
        sim_i = self.image_pairwise_similarity(ref_images, gen_samples)
        sim_t = self.txt_to_img_similarity(target_text, gen_samples)
        return sim_i, sim_t


class DINOScorer:
    """DINO ViT-S/16 CLS-cosine similarity."""

    def __init__(self, vit: ViTEncoder):
        self.vit = vit.eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.vit.cls_token.device

    @torch.inference_mode()
    def get_image_features(self, images) -> torch.Tensor:
        pixels = preprocess_vit_images(torch.as_tensor(np.asarray(images)).to(self.device),
                                       self.vit.cfg.image_size)
        return _normed(self.vit(pixels)[:, 0].float())

    def image_pairwise_similarity(self, images1, images2, reduction="mean"):
        return _reduce(self.get_image_features(images1) @ self.get_image_features(images2).T,
                       reduction)


def init_evaluators(tokenizer=None, clip_ckpt: Optional[str] = None,
                    dino_ckpt: Optional[str] = None, device=None):
    """(CLIPScorer, DINOScorer) on `device` (the CUDA card unless
    `device="cpu"`), fp32. `clip_ckpt` / env `CLIP_SCORER_PT`: a whole HF
    `CLIPModel` state dict (openai/clip-vit-base-patch32); `dino_ckpt` / env
    `DINO_VITS16_PT`: an HF `ViTModel` (facebook/dino-vits16). The tokenizer
    defaults to CLIP's BPE where `CLIP_VOCAB_JSON` and `CLIP_MERGES_TXT` name
    its files, else the hash tokenizer (with a warning when real CLIP
    weights are loaded: CLIP-T is then not comparable to the reference's).
    Without files, random tiny towers from seeds 0-2 and the JAX package's
    projections (`default_rng(0)` normals, [64, 32])."""
    from adaface_tpu_torch.interop.torch_pickle import load_sd_state_dict
    from adaface_tpu_torch.pipeline import build_loaded, build_random

    dev = resolve_device(device)
    clip_ckpt = clip_ckpt or os.environ.get("CLIP_SCORER_PT")
    dino_ckpt = dino_ckpt or os.environ.get("DINO_VITS16_PT")
    has_clip = bool(clip_ckpt and os.path.exists(clip_ckpt))
    if tokenizer is None:
        from adaface_tpu_torch.data.tokenizer import CLIPBPETokenizer, HashTokenizer

        vocab, merges = os.environ.get("CLIP_VOCAB_JSON"), os.environ.get("CLIP_MERGES_TXT")
        if vocab and merges and os.path.exists(vocab) and os.path.exists(merges):
            tokenizer = CLIPBPETokenizer(vocab, merges)
        else:
            tokenizer = HashTokenizer()
            if has_clip:
                warnings.warn(
                    "CLIP_SCORER_PT set but CLIP_VOCAB_JSON/CLIP_MERGES_TXT missing: CLIP-T "
                    "uses a HashTokenizer over real weights, so text-image scores are NOT "
                    "comparable to the reference (CLIP-I/DINO are unaffected).")

    if has_clip:
        from adaface_tpu_torch.interop.hf_clip import map_clip_model_state_dict

        tsd, vsd, tproj, vproj = map_clip_model_state_dict(load_sd_state_dict(clip_ckpt))
        text = build_loaded(lambda: CLIPTextEncoder(clip_b32_text_config()), tsd, dev)
        vision = build_loaded(lambda: CLIPVisionEncoder(CLIPVisionConfig.vit_b_32()), vsd, dev)
        clip = CLIPScorer(tokenizer, text, vision, tproj, vproj)
    else:
        text = build_random(lambda: CLIPTextEncoder(CLIPTextConfig.tiny(
            vocab_size=tokenizer.vocab_size, max_position_embeddings=77)), 0, dev)
        vision = build_random(lambda: CLIPVisionEncoder(CLIPVisionConfig.tiny()), 1, dev)
        rng = np.random.default_rng(0)
        clip = CLIPScorer(tokenizer, text, vision,
                          torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)),
                          torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)))

    if dino_ckpt and os.path.exists(dino_ckpt):
        from adaface_tpu_torch.models.vit import map_vit_state_dict

        vit = build_loaded(lambda: ViTEncoder(ViTConfig.dino_vits16()),
                           map_vit_state_dict(load_sd_state_dict(dino_ckpt)), dev)
    else:
        vit = build_random(lambda: ViTEncoder(ViTConfig.tiny()), 2, dev)
    return clip, DINOScorer(vit)
