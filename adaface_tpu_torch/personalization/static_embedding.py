"""Static layerwise subject embeddings (counterpart of
`adaface_tpu/personalization/static_embedding.py`): K embeddings per token for
each of L=16 cross-attention layers, from a low-rank basis:

    weights  = basis_rand_weights + basis_comm_weights        # [L, K, r]
    basis    = concat(pre_vecs, basis_vecs, axis=1)           # [K, r, D]
    out[l,k] = LayerNorm_no_affine(weights[l,k] @ basis[k]) / sqrt(D) + bias[l,k]
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class StaticEmbedderParams:
    basis_rand_weights: torch.Tensor  # [L, K, r]
    basis_comm_weights: torch.Tensor  # [1, K, r]
    basis_vecs: Optional[torch.Tensor]  # [K, r-N, D], None if pre_vecs span the basis
    pre_vecs: Optional[torch.Tensor]  # [K, N, D] init-word vectors, None if N = 0
    bias: Optional[torch.Tensor]  # [L, K, D]


def init_static_embedder(generator: torch.Generator, num_layers: int = 16,
                         num_vectors: int = 1, emb_dim: int = 768, rank: int = 6,
                         device=None) -> StaticEmbedderParams:
    """The JAX package's init without init words, with draws from
    `generator` (on `device`): standard-normal rank weights around common
    weights 1/rank, random basis vectors normalized to 1/4 with the last one
    zeroed, zero bias. (Init-word vectors, `pre_vecs`, come with training.)"""
    L, K, r, D = num_layers, num_vectors, rank, emb_dim
    brw = torch.randn((L, K, r), generator=generator, device=device)
    bcw = torch.full((1, K, r), 1.0 / r, device=device)
    bv = torch.randn((K, r, D), generator=generator, device=device)
    bv = bv / torch.linalg.norm(bv, dim=-1, keepdim=True) / 4.0
    bv[-1] = 0.0
    return StaticEmbedderParams(brw, bcw, bv, None, torch.zeros((L, K, D), device=device))


def compute_static_embedding(p: StaticEmbedderParams) -> torch.Tensor:
    """[L, K, D] subject embeddings, fp32."""
    weights = (p.basis_rand_weights + p.basis_comm_weights).float()
    parts = [v.float() for v in (p.pre_vecs, p.basis_vecs) if v is not None]
    basis = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    out = torch.einsum("lkr,krd->lkd", weights, basis)
    mean = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, unbiased=False, keepdim=True)
    out = (out - mean) * torch.rsqrt(var + 1e-5)
    out = out / float(np.sqrt(np.float32(out.shape[-1])))
    if p.bias is not None:
        out = out + p.bias.float()
    return out
