"""Placeholder registry and layerwise prompt patching, static embedders only
(counterpart of the static part of
`adaface_tpu/personalization/embedding_manager.py`).

Placeholder occupancy is a dense [B, T] slot map built on the host at
tokenization time (k-th vector slot or -1); the layer axis leads: prompts
patch into [L=16, B, T, D]. A K-vector token occupies K consecutive slots.
Zero-shot generators and checkpoint loading are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from adaface_tpu_torch.personalization.static_embedding import (
    StaticEmbedderParams,
    compute_static_embedding,
    init_static_embedder,
)

NUM_CA_LAYERS = 16


@dataclasses.dataclass
class PlaceholderInfo:
    string: str
    token_id: int  # id in the extended vocabulary
    num_vectors: int  # K


class EmbeddingManager:
    def __init__(self):
        self.placeholders: Dict[str, PlaceholderInfo] = {}
        self.embedders: Dict[str, StaticEmbedderParams] = {}

    def add_placeholder(self, string: str, token_id: int, num_vectors: int = 1,
                        embedder: Optional[StaticEmbedderParams] = None,
                        generator: Optional[torch.Generator] = None,
                        rank: int = 6, emb_dim: int = 768, device=None):
        """Register a placeholder; without `embedder`, a fresh static
        embedder is drawn from `generator` (seeded with the placeholder
        count when None)."""
        self.placeholders[string] = PlaceholderInfo(string, token_id, num_vectors)
        if embedder is None:
            if generator is None:
                generator = torch.Generator(device=device or "cpu")
                generator.manual_seed(len(self.placeholders))
            embedder = init_static_embedder(generator, NUM_CA_LAYERS, num_vectors,
                                            emb_dim=emb_dim, rank=rank, device=device)
        self.embedders[string] = embedder

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
