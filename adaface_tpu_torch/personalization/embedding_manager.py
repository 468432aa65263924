"""Placeholder registry and layerwise prompt patching, static embedders only
(counterpart of the static part of
`adaface_tpu/personalization/embedding_manager.py`).

Placeholder occupancy is a dense [B, T] slot map built on the host at
tokenization time (k-th vector slot or -1); the layer axis leads: prompts
patch into [L=16, B, T, D]. A K-vector token occupies K consecutive slots.
Native checkpoints are the JAX package's `.npz` format (one array per
`<placeholder>::<field>` plus a JSON header), so either package reads the
other's. Zero-shot generators and reference `.pt` loading are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np
import torch

from adaface_tpu_torch.personalization.static_embedding import (
    StaticEmbedderParams,
    compute_static_embedding,
    embedder_leaves,
    init_static_embedder,
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
        self.use_conv_attn_kernel_size: int = -1

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
