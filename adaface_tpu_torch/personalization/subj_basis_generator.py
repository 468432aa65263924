"""Zero-shot subject-basis generator (counterpart of
`adaface_tpu/personalization/subj_basis_generator.py`): identity evidence of
a new subject -> the [B, 16 layers, K, D] prompt embeddings that per-subject
training would have optimized.

- fg face branch: the 16 core Arc2Face embeddings are inverted into the
  token-embedding space by a text encoder (`prompt2token_proj`, gradient
  scaled 0.4) that blends its last 3 hidden states by learnable weights
  (init [1, 2, 4], gradient scaled 5), then broadcast over the 16 layers and
  blended with pad rows by `out_id_embs_scale`;
- fg object branch: DINO features [B, 384] expanded to the 16 core rows;
- bg branch: masked CLIP image features [B, 257, D_img] projected and read
  by 16 * K latent queries through a Perceiver cross-attention, scaled by
  D**-0.5 (no pad blend; a scale other than 1 only multiplies).

Every LayerNorm here is flax's default, eps 1e-6. The bg branch's attention
dropout (p 0.05) runs only when the caller passes a `torch.Generator` to
draw it from (`dropout_generator`; `dropout_stream` gives each generator
its own), never because of the module's train/eval mode; the serving path
passes none. Submodules carry the flax tree's names.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from adaface_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from adaface_tpu_torch.ops.grad import scale_grad
from adaface_tpu_torch.personalization.arc2face import (
    CORE_BEGIN, NUM_CORE_EMBS, inverse_face_prompt_embs, make_pad_embeddings)

FLAX_LN_EPS = 1e-6  # flax's nn.LayerNorm default (torch's is 1e-5)
# the fg generator's DINO object branch, which a face-branch call never reads
OBJECT_BRANCH = ("obj_proj_dense.", "obj_proj_ln.")


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=FLAX_LN_EPS)


class DropoutStream(NamedTuple):
    """An attention-dropout stream: each mask is drawn for `n_rows` rows
    (the global batch of a dp-sliced call; None: the call's own rows) from
    `generator`, and the rows `rows` kept (None: all), so that dp ranks drop
    what one device drops for the whole batch."""

    generator: torch.Generator
    rows: Optional[np.ndarray] = None
    n_rows: Optional[int] = None


def dropout_stream(seed: Optional[int], index: int, device, rows: Optional[np.ndarray] = None,
                   n_rows: Optional[int] = None) -> Optional[DropoutStream]:
    """The dropout stream of the `index`-th generator (sorted placeholder
    order) of an iteration whose dropout seed is `seed`: a fresh
    `torch.Generator` seeded from (seed, index), so every generator has its
    own stream and a second call gives the same masks (the JAX package's
    `fold_in(key, index)`; the numbers differ, the law does not), with the
    call's `rows` of `n_rows` (`DropoutStream`). None for a None seed: no
    dropout."""
    if seed is None:
        return None
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
    return DropoutStream(torch.Generator(device=device).manual_seed(int(state) & (2 ** 63 - 1)),
                         rows, n_rows)


def attention_dropout(attn: torch.Tensor, p: float,
                      stream: Optional[DropoutStream]) -> torch.Tensor:
    """flax's `nn.Dropout`: each entry kept with probability 1 - p and then
    divided by it, the mask drawn from `stream`; the identity when `stream`
    is None."""
    if stream is None or p == 0:
        return attn
    u = torch.rand((stream.n_rows or attn.shape[0],) + tuple(attn.shape[1:]),
                   generator=stream.generator, device=attn.device)
    if stream.rows is not None:
        u = u[torch.as_tensor(stream.rows, device=attn.device)]
    keep = u >= p
    return torch.where(keep, attn / (1.0 - p), torch.zeros((), dtype=attn.dtype,
                                                           device=attn.device))


class PerceiverCrossAttention(nn.Module):
    """The reference resampler's `CrossAttention` as the bg translator uses
    it: bias-free linear + LayerNorm projections of q, k and v, q and k each
    scaled by d**-0.25, the context added to v as a skip, and no output
    projection (the reference's `to_out` is the identity there)."""

    def __init__(self, dim: int, num_heads: int = 6, p_dropout: float = 0.05):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        for name in ("to_q", "to_k", "to_v"):
            self.add_module(f"{name}_dense", nn.Linear(dim, dim, bias=False))
            self.add_module(f"{name}_ln", _ln(dim))
        self.p_dropout = p_dropout

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                dropout_generator: Optional[DropoutStream] = None) -> torch.Tensor:
        h = self.num_heads
        d = self.dim // h
        proj = lambda name, t: getattr(self, f"{name}_ln")(getattr(self, f"{name}_dense")(t))
        q, k = proj("to_q", x), proj("to_k", context)
        v = proj("to_v", context) + context
        B, Q, _ = q.shape
        L = k.shape[1]
        split = lambda t, n: t.reshape(B, n, h, d).transpose(1, 2)
        scale = d ** -0.25
        sim = torch.matmul((split(q, Q) * scale).float(),
                           (split(k, L) * scale).float().transpose(-1, -2))
        attn = attention_dropout(torch.softmax(sim, dim=-1).to(v.dtype), self.p_dropout,
                                 dropout_generator)
        return torch.matmul(attn, split(v, L)).transpose(1, 2).reshape(B, Q, self.dim)


class SubjBasisGenerator(nn.Module):
    """One generator per placeholder string (fg subject or bg)."""

    def __init__(self, placeholder_is_bg: bool = False, num_out_layers: int = 16,
                 num_out_embs_per_layer: int = 16, output_dim: int = 768,
                 image_embedding_dim: int = 1280, dino_embedding_dim: int = 384,
                 num_heads: int = 6, prompt2token_proj_grad_scale: float = 0.4,
                 hidden_state_weights_grad_scale: float = 5.0,
                 zs_extra_words_scale: float = 0.5,
                 proj_cfg: Optional[CLIPTextConfig] = None, pad_token_id: int = 49407,
                 bg_num_id_vecs: int = 257, fg_num_id_vecs: int = 77):
        super().__init__()
        self.placeholder_is_bg = placeholder_is_bg
        self.num_out_layers = num_out_layers
        self.num_out_embs_per_layer = num_out_embs_per_layer
        self.output_dim = D = output_dim
        self.prompt2token_proj_grad_scale = prompt2token_proj_grad_scale
        self.hidden_state_weights_grad_scale = hidden_state_weights_grad_scale
        self.zs_extra_words_scale = zs_extra_words_scale
        self.pad_token_id = pad_token_id
        n_id = bg_num_id_vecs if placeholder_is_bg else fg_num_id_vecs
        # the fg pos_embs are never read; they keep checkpoints shape-exact
        self.pos_embs = nn.Parameter(torch.empty(1, n_id, D))
        if placeholder_is_bg:
            self.pos_embs_ln = _ln(D)
            self.bg_proj_dense = nn.Linear(image_embedding_dim, D, bias=False)
            self.bg_proj_ln = _ln(D)
            self.latent_queries = nn.Parameter(
                torch.empty(1, num_out_layers * num_out_embs_per_layer, D))
            self.latent_queries_ln = _ln(D)
            self.prompt_translator = PerceiverCrossAttention(D, num_heads)
        else:
            self.prompt2token_proj = CLIPTextEncoder(proj_cfg or CLIPTextConfig.vit_l_14())
            self.hidden_state_layer_weights = nn.Parameter(torch.empty(3, 1))
            self.obj_proj_dense = nn.Linear(dino_embedding_dim, NUM_CORE_EMBS * D, bias=False)
            self.obj_proj_ln = _ln(D)

    def face_trainable_parameters(self) -> list:
        """The parameters zero-shot training updates: all but the fg object
        branch (the JAX package's tree from a face-branch init holds the
        same leaves)."""
        return [p for n, p in self.named_parameters() if not n.startswith(OBJECT_BRANCH)]

    def forward(self, clip_features: Optional[torch.Tensor],
                raw_id_embs: Optional[torch.Tensor],
                arc2face_id_embs: Optional[torch.Tensor],
                out_id_embs_scale: float = 1.0, is_face: bool = True,
                is_training: bool = False, inverse_template_ids=None,
                arc2face_inverse_prompt_embs_inf_type: str = "full_half_pad",
                dropout_generator: Optional[DropoutStream] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns (output_embs [B, L, K, D], inverse prompt embeddings
        [B, T, D] of the fg face branch, else None). clip_features
        [B, 257, D_img] feed the bg branch, raw_id_embs [B, 384] (DINO) the
        fg object branch, arc2face_id_embs [B, 16, D] the fg face branch.
        `dropout_generator` turns on the bg branch's attention dropout."""
        D, K, L = self.output_dim, self.num_out_embs_per_layer, self.num_out_layers
        dtype = self.pos_embs.dtype
        if self.placeholder_is_bg:
            B = clip_features.shape[0]
            id_embs = self.bg_proj_ln(self.bg_proj_dense(clip_features.to(dtype)))
            id_embs = id_embs + self.pos_embs_ln(self.pos_embs)
            latents = self.latent_queries_ln(self.latent_queries).expand(B, L * K, D)
            out = self.prompt_translator(latents, id_embs, dropout_generator)
            output_embs = out.reshape(B, L, K, D) * (D ** -0.5)
            if out_id_embs_scale != 1.0:
                output_embs = output_embs * out_id_embs_scale
            return output_embs, None

        inverse_prompt_embs = None
        if is_face:
            if arc2face_id_embs is None:
                raise ValueError("the fg face branch needs arc2face_id_embs")
            B = arc2face_id_embs.shape[0]
            T = inverse_template_ids.shape[1] if inverse_template_ids is not None else 77
            pad_embeddings = make_pad_embeddings(
                self.prompt2token_proj, self.pad_token_id, T).detach()
            hslw = scale_grad(self.hidden_state_layer_weights,
                              self.hidden_state_weights_grad_scale)
            emb_type = "full_pad" if is_training else arc2face_inverse_prompt_embs_inf_type
            inverse_prompt_embs, core_id_embs = inverse_face_prompt_embs(
                self.prompt2token_proj, arc2face_id_embs.to(dtype), inverse_template_ids,
                pad_embeddings,
                (emb_type, "core"), hidden_state_layer_weights=hslw,
                zs_extra_words_scale=self.zs_extra_words_scale)
            # a slower update rate for prompt2token_proj
            inverse_prompt_embs = scale_grad(inverse_prompt_embs,
                                             self.prompt2token_proj_grad_scale)
            core_id_embs = scale_grad(core_id_embs, self.prompt2token_proj_grad_scale)
        elif raw_id_embs is not None:
            B = raw_id_embs.shape[0]
            pad_embeddings = make_pad_embeddings(
                self.prompt2token_proj, self.pad_token_id, 77).detach()
            core_id_embs = self.obj_proj_ln(
                self.obj_proj_dense(raw_id_embs.to(dtype)).reshape(B, NUM_CORE_EMBS, D))
        else:
            raise ValueError("the subject branch needs arc2face_id_embs or raw_id_embs")

        if K != NUM_CORE_EMBS:
            raise ValueError(f"subject K={K} must equal the {NUM_CORE_EMBS} core id embeddings")
        id_embs_out = core_id_embs[:, None].expand(B, L, NUM_CORE_EMBS, D)
        pad_rows = pad_embeddings[CORE_BEGIN - 2:CORE_BEGIN - 2 + K]
        output_embs = (id_embs_out * out_id_embs_scale
                       + pad_rows[None, None] * (1.0 - out_id_embs_scale))
        return output_embs, inverse_prompt_embs
