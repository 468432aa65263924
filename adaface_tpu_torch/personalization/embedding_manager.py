"""Placeholder registry and layerwise prompt patching (counterpart of
`adaface_tpu/personalization/embedding_manager.py`): static embedders and
zero-shot generators.

Placeholder occupancy is a dense [B, T] slot map built on the host at
tokenization time (k-th vector slot or -1); the layer axis leads: prompts
patch into [L=16, B, T, D]. A K-vector token occupies K consecutive slots.
Native checkpoints are the JAX package's `.npz` format (one array per
`<placeholder>::<field>` plus a JSON header), so either package reads the
other's. A zero-shot placeholder takes its embeddings from a
`SubjBasisGenerator` fed by reference-image features (`arc2face_encoder`
runs the frozen Arc2Face forward first). `load_reference_checkpoint`
imports a reference `embeddings_gs-*.pt` (static embedders and zero-shot
generators, read without running pickled code).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from adaface_tpu_torch.personalization.arc2face import forward_face_embs
from adaface_tpu_torch.personalization.static_embedding import (
    StaticEmbedderParams,
    compute_static_embedding,
    embedder_leaves,
    init_static_embedder,
    static_embedder_from_torch_stub,
)

NUM_CA_LAYERS = 16
_FIELDS = [f.name for f in dataclasses.fields(StaticEmbedderParams)]


@dataclasses.dataclass
class PlaceholderInfo:
    string: str
    token_id: int  # id in the extended vocabulary
    num_vectors: int  # K
    is_background: bool = False


class EmbeddingManager:
    def __init__(self):
        self.placeholders: Dict[str, PlaceholderInfo] = {}
        self.embedders: Dict[str, StaticEmbedderParams] = {}
        self.emb_global_scale_scores: Dict[str, float] = {}
        # zero-shot: placeholder -> SubjBasisGenerator
        self.subj_basis_generators: Dict[str, nn.Module] = {}
        # the frozen Arc2Face text encoder (a CLIPTextEncoder)
        self.arc2face_encoder: Optional[nn.Module] = None
        self.use_conv_attn_kernel_size: int = -1

    # ----------------------------------------------------------- zero-shot
    def add_zero_shot_placeholder(self, string: str, token_id: int, generator: nn.Module,
                                  num_vectors: Optional[int] = None,
                                  is_background: bool = False):
        """Register a placeholder whose embeddings come from `generator` (a
        `SubjBasisGenerator`); no static embedder is made for it.
        `num_vectors` defaults to the generator's K (16 fg, 4 bg) and must
        equal it: more slots than the generator emits would repeat its last
        embedding into the extra ones."""
        gen_k = getattr(generator, "num_out_embs_per_layer", None)
        if num_vectors is None:
            num_vectors = gen_k if gen_k is not None else 16
        elif gen_k is not None and num_vectors != gen_k:
            raise ValueError(f"placeholder '{string}': num_vectors={num_vectors} != the "
                             f"generator's num_out_embs_per_layer={gen_k}")
        self.placeholders[string] = PlaceholderInfo(string, token_id, num_vectors,
                                                    is_background)
        self.subj_basis_generators[string] = generator
        self.emb_global_scale_scores.setdefault(string, 0.0)

    def compute_zero_shot_embeddings(self, features, inverse_template_ids,
                                     forward_template_ids=None,
                                     arcface_token_id: Optional[int] = None,
                                     out_id_embs_scale: float = 1.0, is_face: bool = True,
                                     is_training: bool = False,
                                     inf_emb_type: str = "full_half_pad"
                                     ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
        """placeholder -> [L, B, K, D] zero-shot embeddings, and the fg
        subject's inverse prompt embeddings: id embeddings -> the frozen
        Arc2Face forward -> each placeholder's generator. `features` is a
        `ZeroShotFeatures`; the template ids are [1, T]."""
        arc2face_id_embs = None
        if is_face and features.id_embs is not None:
            if self.arc2face_encoder is None:
                raise ValueError("set arc2face_encoder for zero-shot faces")
            _, arc2face_id_embs = forward_face_embs(
                self.arc2face_encoder, features.id_embs.detach(), forward_template_ids,
                arcface_token_id)
        out: Dict[str, torch.Tensor] = {}
        inverse_prompt_embs = None
        for s, gen in self.subj_basis_generators.items():
            info = self.placeholders[s]
            embs, inv = gen(features.clip_bg if info.is_background else features.clip_fg,
                            None if is_face else features.id_embs, arc2face_id_embs,
                            out_id_embs_scale=out_id_embs_scale, is_face=is_face,
                            is_training=is_training, inverse_template_ids=inverse_template_ids,
                            arc2face_inverse_prompt_embs_inf_type=inf_emb_type)
            out[s] = embs.transpose(0, 1)  # [B, L, K, D] -> [L, B, K, D]
            if inv is not None and not info.is_background:
                inverse_prompt_embs = inv
        return out, inverse_prompt_embs

    def add_placeholder(self, string: str, token_id: int, num_vectors: int = 1,
                        is_background: bool = False,
                        embedder: Optional[StaticEmbedderParams] = None,
                        generator: Optional[torch.Generator] = None,
                        init_vecs: Optional[np.ndarray] = None,
                        init_vec_weights: Optional[np.ndarray] = None,
                        rank: int = 6, emb_dim: int = 768, device=None):
        """Register a placeholder; without `embedder`, a fresh static
        embedder is drawn from `generator` (seeded with the placeholder
        count when None), initialized from `init_vecs` when given."""
        self.placeholders[string] = PlaceholderInfo(string, token_id, num_vectors,
                                                    is_background)
        if embedder is None:
            if generator is None:
                generator = torch.Generator(device=device or "cpu")
                generator.manual_seed(len(self.placeholders))
            embedder = init_static_embedder(generator, NUM_CA_LAYERS, num_vectors,
                                            emb_dim=emb_dim, rank=rank,
                                            init_vecs=init_vecs,
                                            init_vec_weights=init_vec_weights,
                                            device=device)
        self.embedders[string] = embedder
        self.emb_global_scale_scores.setdefault(string, 0.0)

    def build_slot_maps(self, token_ids: np.ndarray) -> Dict[str, np.ndarray]:
        """Placeholder -> [B, T] int32 map: k at the k-th vector slot of the
        FIRST occurrence of the placeholder in each row, -1 elsewhere."""
        token_ids = np.asarray(token_ids)
        B, T = token_ids.shape
        maps = {}
        for s, info in self.placeholders.items():
            m = np.full((B, T), -1, dtype=np.int32)
            for b in range(B):
                pos = np.nonzero(token_ids[b] == info.token_id)[0]
                if len(pos) == 0:
                    continue
                p = int(pos[0])
                for k in range(info.num_vectors):
                    if p + k < T:
                        m[b, p + k] = k
            maps[s] = m
        return maps

    def compute_subject_embeddings(self) -> Dict[str, torch.Tensor]:
        """Placeholder -> [L, K, D]."""
        return {s: compute_static_embedding(p) for s, p in self.embedders.items()}

    @staticmethod
    def patch_prompt_embeddings(embedded_text: torch.Tensor,
                                slot_maps: Dict[str, np.ndarray],
                                subject_embs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[B, T, D] token embeddings -> [L, B, T, D] with placeholder slots
        replaced by the subject embeddings ([L, K, D], broadcast over the
        batch, or per-instance [L, B, K, D])."""
        out = embedded_text[None].expand((NUM_CA_LAYERS,) + tuple(embedded_text.shape))
        B = embedded_text.shape[0]
        dev = embedded_text.device
        for s, emb in subject_embs.items():
            sm = torch.as_tensor(np.asarray(slot_maps[s]), dtype=torch.long, device=dev)
            k = sm.clamp(min=0)
            if emb.dim() == 3:
                gathered = emb[:, k]
            else:
                gathered = emb[:, torch.arange(B, device=dev)[:, None], k]
            keep = (sm >= 0)[None, :, :, None]
            out = torch.where(keep, gathered.to(out.dtype), out)
        return out

    @staticmethod
    def distribute_cls_embeddings(ctx: torch.Tensor, slot_map) -> torch.Tensor:
        """The class word spread over the K vector slots of a class prompt
        ("person , , ,"): at the K slot positions (slot map from the SUBJECT
        prompt), ctx [L, B, T, D] takes the first slot position's embedding
        / sqrt(K). Rows without the placeholder, or with K = 1, pass through."""
        sm = torch.as_tensor(np.asarray(slot_map), dtype=torch.long, device=ctx.device)
        is_slot = sm >= 0  # [B, T]
        m = is_slot.sum(dim=1)  # [B]
        B = sm.shape[0]
        pos0 = torch.argmax((sm == 0).to(torch.int32), dim=1)  # first-slot position
        first = ctx[:, torch.arange(B, device=ctx.device), pos0]  # [L, B, D]
        repl = first / torch.sqrt(torch.clamp_min(m, 1).to(ctx.dtype))[None, :, None]
        keep = (is_slot & (m > 1)[:, None])[None, :, :, None]
        return torch.where(keep, repl[:, :, None, :], ctx)

    # ------------------------------------------------------------ checkpoints
    def save_native(self, path: str):
        """`.npz` with one array per `<placeholder>::<field>` and a JSON
        header (placeholders, scores, conv-attention kernel size), the JAX
        package's native format."""
        arrays = {}
        header = {"placeholders": [],
                  "use_conv_attn_kernel_size": self.use_conv_attn_kernel_size}
        for s, info in self.placeholders.items():
            if s not in self.embedders:
                continue
            header["placeholders"].append(dataclasses.asdict(info))
            header.setdefault("scores", {})[s] = float(self.emb_global_scale_scores.get(s, 0.0))
            for fname, v in embedder_leaves(self.embedders[s]):
                arrays[f"{s}::{fname}"] = v.detach().float().cpu().numpy()
        arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
        np.savez(path, **arrays)

    @classmethod
    def load_native(cls, path: str, device=None) -> "EmbeddingManager":
        z = np.load(path)
        header = json.loads(bytes(z["__header__"]).decode())
        mgr = cls()
        mgr.use_conv_attn_kernel_size = header.get("use_conv_attn_kernel_size", -1)
        for pdict in header["placeholders"]:
            s = pdict["string"]
            fields = {f: (torch.as_tensor(z[f"{s}::{f}"], device=device)
                          if f"{s}::{f}" in z.files else None) for f in _FIELDS}
            mgr.placeholders[s] = PlaceholderInfo(**pdict)
            mgr.embedders[s] = StaticEmbedderParams(**fields)
            mgr.emb_global_scale_scores[s] = header.get("scores", {}).get(s, 0.0)
        return mgr

    def load_reference_checkpoint(self, path: str, token_id_resolver=None,
                                  placeholder_remap: Optional[Dict[str, str]] = None,
                                  load_subj_basis_generators: bool = True,
                                  extend_attention_multiplier: int = -1,
                                  ext_perturb_ratio: float = 0.0,
                                  ext_generator: Optional[torch.Generator] = None,
                                  device=None) -> "EmbeddingManager":
        """Import a reference `embeddings_gs-*.pt` (the JAX package's
        `load_reference_checkpoint`). `token_id_resolver(string)` gives a
        placeholder's token id (default: sequential ids from 49408);
        `placeholder_remap` renames placeholders as they load. K comes from
        the embedder's bias when it has one, else `token2num_vectors`; the
        checkpoint's scores align with its `string_to_token_dict` order. A
        degenerate embedder (no `basis_vecs`, no `pre_vecs`: the zero-shot
        passthrough) registers its placeholder but no embedder. The
        checkpoint's `use_conv_attn_kernel_size` is kept. Zero-shot
        generators load through `_load_subj_basis_generators`. Embedders
        land on `device` (CPU by default), generators too."""
        from adaface_tpu_torch.interop.torch_pickle import (
            TorchObjectStub, load_torch_checkpoint, walk_stub_tree)

        ckpt = load_torch_checkpoint(path)
        remap = placeholder_remap or {}
        token2num = {str(k): int(torch.as_tensor(v)) for k, v in
                     dict(ckpt.get("token2num_vectors") or {}).items()}
        score_by_name = {}
        if ckpt.get("emb_global_scale_scores") is not None:
            names = list(dict(ckpt.get("string_to_token_dict") or {}).keys())
            scores = torch.as_tensor(ckpt["emb_global_scale_scores"]).reshape(-1)
            score_by_name = {str(n): float(scores[i]) for i, n in enumerate(names)
                             if i < len(scores)}
        bg_strings = list(ckpt.get("background_strings") or [])
        embedders = ckpt["string_to_static_embedder"]
        if isinstance(embedders, TorchObjectStub):  # a ModuleDict / ParameterDict
            d = embedders.__dict__
            items = dict(d.get("_parameters") or {})
            items.update(d.get("_modules") or {})
        else:
            items = dict(embedders)
        next_id = 49408 + len(self.placeholders)
        for name, stub in items.items():
            target = remap.get(name, name)
            params = static_embedder_from_torch_stub(walk_stub_tree(stub), device)
            K = token2num.get(name, 1)
            if params.bias is not None:
                K = params.bias.shape[1]
            if token_id_resolver is not None:
                tid = token_id_resolver(target)
            else:
                tid, next_id = next_id, next_id + 1
            self.placeholders[target] = PlaceholderInfo(target, tid, K,
                                                        is_background=name in bg_strings)
            if params.basis_vecs is not None or params.pre_vecs is not None:
                self.embedders[target] = params
            self.emb_global_scale_scores[target] = score_by_name.get(
                name, self.emb_global_scale_scores.get(target, 0.0))
        ks = ckpt.get("use_conv_attn_kernel_size")
        if ks is not None:
            try:
                self.use_conv_attn_kernel_size = int(torch.as_tensor(ks))
            except (TypeError, ValueError, RuntimeError):
                pass
        if load_subj_basis_generators:
            self._load_subj_basis_generators(ckpt, remap, extend_attention_multiplier,
                                             ext_perturb_ratio, ext_generator, device)
        return self

    def _load_subj_basis_generators(self, ckpt, remap, extend_attention_multiplier=-1,
                                    ext_perturb_ratio=0.0, ext_generator=None, device=None):
        """Import `string_to_subj_basis_generator_dict`. With
        `extend_attention_multiplier` > 1, an fg generator's text encoder
        is MKV-extended as it loads: an unextended checkpoint on every
        layer by the multiplier; one already extended by m0 (the
        multiplier a multiple of m0 above it) on layers 0-3 by the ratio.
        A placeholder already registered takes the generator (and its bg
        flag); a new one is added with token id 49408 + the number of
        placeholders."""
        from adaface_tpu_torch.interop.subj_basis import (
            load_generator, map_subj_basis_generator, proj_config_from_meta)
        from adaface_tpu_torch.interop.torch_pickle import TorchObjectStub
        from adaface_tpu_torch.personalization.arc2face import extend_clip_mkv_params

        gens = ckpt.get("string_to_subj_basis_generator_dict")
        if gens is None:
            return
        items = (dict(gens.__dict__.get("_modules") or {})
                 if isinstance(gens, TorchObjectStub) else dict(gens))
        for name, stub in items.items():
            target = remap.get(name, name)
            sd, meta = map_subj_basis_generator(stub)
            if not meta.placeholder_is_bg and extend_attention_multiplier > 1:
                proj_cfg = proj_config_from_meta(meta)
                m0 = max(meta.kv_multipliers or (1,))
                span = None
                if m0 == 1:
                    span = (extend_attention_multiplier, -1, -1)
                elif (extend_attention_multiplier % m0 == 0
                      and extend_attention_multiplier > m0):
                    span = (extend_attention_multiplier // m0, 0, 3)
                if span is not None:
                    proj = {k[len("prompt2token_proj."):]: v for k, v in sd.items()
                            if k.startswith("prompt2token_proj.")}
                    proj, proj_cfg = extend_clip_mkv_params(
                        proj, proj_cfg, ext_generator, multiplier=span[0],
                        noise_std=ext_perturb_ratio, begin_layer_idx=span[1],
                        end_layer_idx=span[2])
                    sd.update({"prompt2token_proj." + k: v for k, v in proj.items()})
                meta = dataclasses.replace(meta, kv_multipliers=proj_cfg.kv_multipliers)
            gen = load_generator(sd, meta, device=device)
            info = self.placeholders.get(target)
            if info is not None:
                info.is_background = meta.placeholder_is_bg or info.is_background
                self.subj_basis_generators[target] = gen
            else:
                self.add_zero_shot_placeholder(
                    target, token_id=49408 + len(self.placeholders), generator=gen,
                    num_vectors=meta.num_out_embs_per_layer,
                    is_background=meta.placeholder_is_bg)
