"""The Arc2Face teacher of distillation iterations (counterpart of
`adaface_tpu/training/arc2face_teacher.py`).

A frozen UNet (the Arc2Face release: SD v1.5's architecture in the diffusers
layout, `interop/diffusers_unet.py`) and a frozen CLIP text encoder (an HF
CLIPTextModel, `interop/hf_clip.py`) that turns a face identity embedding
into the teacher's prompt context ("photo of a id person",
`personalization/arc2face.forward_face_embs`). The identity comes from
`face_embed_fn` on each example's image, or is a standard normal draw from
the teacher's own numpy rng on a random-face iteration, without an embedder,
or for an image where no face is found; rows are L2-normalized.

`as_tuple()` gives the `(teacher_unet, ctx_fn)` pair `Trainer.fit(
arc2face_teacher=...)` takes.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from adaface_tpu_torch.device import resolve_device
from adaface_tpu_torch.interop.checkpoint_io import find_weights_file, load_state_dict_file
from adaface_tpu_torch.interop.diffusers_unet import load_diffusers_unet
from adaface_tpu_torch.interop.hf_clip import (
    HF_TEXT_FILES,
    map_clip_text_state_dict,
    text_config_from_state_dict,
)
from adaface_tpu_torch.models.clip_text import CLIPTextEncoder
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.personalization.arc2face import (
    ARCFACE_EMB_DIM,
    FORWARD_TEMPLATE,
    forward_face_embs,
    make_template_ids,
)


class Arc2FaceTeacher:
    def __init__(self, unet: UNetModel, encoder: CLIPTextEncoder, tokenizer,
                 face_embed_fn: Optional[Callable] = None):
        self.unet = unet.eval().requires_grad_(False)
        self.encoder = encoder.eval().requires_grad_(False)
        self.face_embed_fn = face_embed_fn
        self._fwd_ids = make_template_ids(tokenizer, FORWARD_TEMPLATE)
        self._id_tok = int(tokenizer.encode("id")[0])
        self._rng = np.random.default_rng(0)

    def _id_embs(self, examples: Sequence[dict], plan) -> np.ndarray:
        B = len(examples)
        if plan.gen_arc2face_rand_face or self.face_embed_fn is None:
            embs = self._rng.standard_normal((B, ARCFACE_EMB_DIM)).astype(np.float32)
        else:
            rows = []
            for e in examples:
                v = self.face_embed_fn(e["image_unnorm"])
                if v is None:  # no face found
                    v = self._rng.standard_normal(ARCFACE_EMB_DIM).astype(np.float32)
                rows.append(np.asarray(v, np.float32))
            embs = np.stack(rows)
        return embs / (np.linalg.norm(embs, axis=-1, keepdims=True) + 1e-12)

    @torch.no_grad()
    def ctx(self, examples: Sequence[dict], plan) -> torch.Tensor:
        """[B, 77, D] Arc2Face prompt context of the examples' identities."""
        dev = self.encoder.token_embedding.weight.device
        id_embs = torch.as_tensor(self._id_embs(examples, plan), device=dev)
        full, _ = forward_face_embs(self.encoder, id_embs, self._fwd_ids, self._id_tok)
        return full

    def as_tuple(self):
        return self.unet, self.ctx


def load_arc2face_teacher(unet_path: str, text_encoder_path: str, tokenizer,
                          face_embed_fn: Optional[Callable] = None,
                          dtype: torch.dtype = torch.float32,
                          unet_cfg: Optional[UNetConfig] = None,
                          device=None) -> Arc2FaceTeacher:
    """The teacher from released Arc2Face weights: `unet_path` a diffusers
    UNet file or directory, `text_encoder_path` a CLIPTextModel file
    (`.safetensors` or torch `.bin` / `.pt`) or a directory holding
    `model.safetensors` / `pytorch_model.bin`. `unet_cfg` defaults to SD
    v1.5's; the models are made on `device` (the card unless "cpu"): the
    UNet in `dtype`, the text encoder in fp32 whatever `dtype` is, as JAX
    builds it, so the teacher's context is fp32 on every run (the teacher
    UNet casts it where it takes it)."""
    dev = resolve_device(device)

    def built(build, state_dict, dt):
        with torch.device("meta"):
            m = build()
        m = m.to_empty(device=dev).to(dt)
        m.load_state_dict(state_dict, strict=True)
        return m

    ucfg = unet_cfg or UNetConfig.sd_v1()
    unet = built(lambda: UNetModel(ucfg), load_diffusers_unet(unet_path, ucfg), dtype)
    if dev.type == "cuda":
        unet = unet.to(memory_format=torch.channels_last)
    sd = load_state_dict_file(find_weights_file(text_encoder_path, HF_TEXT_FILES))
    prefix = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    cfg = text_config_from_state_dict(sd, prefix)
    enc = built(lambda: CLIPTextEncoder(cfg), map_clip_text_state_dict(sd, cfg.num_layers, prefix),
                torch.float32)
    return Arc2FaceTeacher(unet, enc, tokenizer, face_embed_fn)
