"""Zero-shot feature extraction: fg/bg CLIP features and face identity
embeddings of reference images (counterpart of
`adaface_tpu/personalization/zero_shot.py`).

- Reference images -> center crop and nearest resize on the host ->
  CLIP-normalized pixels -> the masked CLIP vision tower's penultimate
  hidden state, minus the features of an all-zero "negative" image (zero
  in normalized space, all-ones mask, computed once per extractor), times
  the token mask; once with the fg mask, once with its complement.
- Face identity comes from an injected callable (image -> 512-d embedding,
  or None where no face is found). A faceless image gets a standard normal
  draw from the numpy `rng` and is counted. Non-face subjects take a DINO
  embedding from another callable.
- `calc_avg` averages the features over the images and L2-normalizes the
  mean identity embedding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from adaface_tpu_torch.models.clip_vision import CLIPVisionEncoder, preprocess_images


@dataclasses.dataclass
class ZeroShotFeatures:
    clip_fg: torch.Tensor  # [B, 257, D]
    clip_bg: torch.Tensor  # [B, 257, D]
    id_embs: Optional[torch.Tensor]  # [B, 512] face, [B, 384] DINO
    faceless_img_count: int = 0

    @property
    def clip_features(self) -> torch.Tensor:
        """[B, 514, D]: fg and bg features side by side."""
        return torch.cat([self.clip_fg, self.clip_bg], dim=1)


class ZeroShotFeatureExtractor:
    """Holds the vision tower (on its device) and the identity callables."""

    def __init__(self, vision: CLIPVisionEncoder,
                 face_embed_fn: Optional[Callable[[np.ndarray], Optional[np.ndarray]]] = None,
                 dino_embed_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 feature_layer: int = -2):
        self.vision = vision.eval()
        self.face_embed_fn = face_embed_fn
        self.dino_embed_fn = dino_embed_fn
        self.feature_layer = feature_layer
        self._neg_features = None

    @property
    def device(self) -> torch.device:
        return self.vision.class_embedding.device

    def _masked_pass(self, pixels: torch.Tensor, mask: torch.Tensor):
        feats, _, token_mask = self.vision(pixels, attn_mask=mask,
                                           feature_layer=self.feature_layer)
        return feats, token_mask

    def _neg(self, pixels: torch.Tensor) -> torch.Tensor:
        """Features of an all-zero image, cached."""
        if self._neg_features is None:
            zero = torch.zeros_like(pixels[:1])
            self._neg_features, _ = self._masked_pass(zero, torch.ones(zero.shape[:3],
                                                                       device=zero.device))
        return self._neg_features

    @torch.inference_mode()
    def encode(self, images: Sequence[np.ndarray], fg_masks: Optional[Sequence[np.ndarray]] = None,
               is_face: bool = True, calc_avg: bool = False, skip_non_faces: bool = False,
               rng: Optional[np.random.Generator] = None) -> ZeroShotFeatures:
        """images: [H, W, 3] uint8 RGB each; fg_masks: [H, W] each, or None
        (all foreground)."""
        rng = rng or np.random.default_rng(0)
        size = self.vision.cfg.image_size
        faceless = 0
        id_embs, keep = [], []
        for idx, image in enumerate(images):
            if is_face and self.face_embed_fn is not None:
                emb = self.face_embed_fn(image)
                if emb is None:
                    if skip_non_faces:
                        continue
                    emb = rng.standard_normal(512).astype(np.float32)
                    faceless += 1
                id_embs.append(np.asarray(emb, np.float32))
            elif not is_face and self.dino_embed_fn is not None:
                id_embs.append(np.asarray(self.dino_embed_fn(image), np.float32))
            keep.append(idx)
        if not keep:
            raise ValueError(f"no usable reference images: {len(images)} given, "
                             f"0 kept (skip_non_faces={skip_non_faces})")
        dev = self.device
        batch = np.stack([_center_crop_resize(images[i], size) for i in keep])
        pixels = preprocess_images(torch.from_numpy(batch).to(dev), size)
        if fg_masks is not None:
            mask = np.stack([_resize_mask(fg_masks[i], size) for i in keep])
        else:
            mask = np.ones((len(keep), size, size), np.float32)
        mask = torch.from_numpy(mask).to(dev)

        neg = self._neg(pixels)
        fg_feats, fg_tok = self._masked_pass(pixels, mask)
        bg_feats, bg_tok = self._masked_pass(pixels, 1.0 - mask)
        fg = (fg_feats - neg) * fg_tok
        bg = (bg_feats - neg) * bg_tok

        ids = torch.from_numpy(np.stack(id_embs)).to(dev) if id_embs else None
        if calc_avg:
            fg = fg.mean(dim=0, keepdim=True)
            bg = bg.mean(dim=0, keepdim=True)
            if ids is not None:
                ids = ids.mean(dim=0, keepdim=True)
                ids = ids / (torch.linalg.vector_norm(ids, dim=-1, keepdim=True) + 1e-12)
        return ZeroShotFeatures(fg, bg, ids, faceless)


def _center_crop_resize(image: np.ndarray, size: int) -> np.ndarray:
    """Square center crop and nearest resize (the host half of
    CLIPImageProcessor)."""
    h, w = image.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    sq = image[top:top + s, left:left + s]
    ri = (np.arange(size) * (s / size)).astype(np.int64)
    return sq[ri][:, ri]


def _resize_mask(mask: np.ndarray, size: int) -> np.ndarray:
    """`_center_crop_resize` of a mask (the same crop and gather, so image
    and mask stay aligned), a trailing channel dropped."""
    m = np.asarray(mask, np.float32)
    if m.ndim == 3:
        m = m[..., 0]
    return _center_crop_resize(m, size)
