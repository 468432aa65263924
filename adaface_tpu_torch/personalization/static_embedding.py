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
                         init_vecs: Optional[np.ndarray] = None,
                         init_vec_weights: Optional[np.ndarray] = None,
                         init_noise_stds=(0.1, 0.04), has_bias: bool = True,
                         device=None) -> StaticEmbedderParams:
    """The JAX package's init, with draws from `generator` (on `device`):
    standard-normal rank weights; random basis vectors normalized to 1/4
    with the last one zeroed; zero bias when `has_bias`. With `init_vecs`
    [N, D] (class-word embeddings): pre_vecs repeat them for each of the K
    vectors, the common weights are 1/N (times 0.4 past the N init words,
    or `init_vec_weights` on them) and the random weights are scaled by
    init_noise_stds[1] on the init words and [0] past them; without, the
    common weights are 1/rank. fp32 throughout."""
    L, K, r, D = num_layers, num_vectors, rank, emb_dim
    brw = torch.randn((L, K, r), generator=generator, device=device)
    if init_vecs is not None:
        iv = torch.as_tensor(np.asarray(init_vecs, np.float32), device=device)
        N = iv.shape[0]
        pre_vecs = iv[None].repeat(K, 1, 1)
        bcw = torch.full((1, K, r), 1.0 / N, device=device)
        bcw[:, :, N:] *= 0.4
        if init_vec_weights is not None:
            bcw[:, :, :N] = torch.as_tensor(np.asarray(init_vec_weights, np.float32),
                                            device=device)[None, None, :]
        brw[:, :, :N] *= init_noise_stds[1]
        brw[:, :, N:] *= init_noise_stds[0]
    else:
        N = 0
        pre_vecs = None
        bcw = torch.full((1, K, r), 1.0 / r, device=device)
    basis_vecs = None
    if r - N > 0:
        bv = torch.randn((K, r - N, D), generator=generator, device=device)
        basis_vecs = bv / torch.linalg.norm(bv, dim=-1, keepdim=True) / 4.0
        basis_vecs[-1] = 0.0
    bias = torch.zeros((L, K, D), device=device) if has_bias else None
    return StaticEmbedderParams(brw, bcw, basis_vecs, pre_vecs, bias)


def embedder_leaves(p: StaticEmbedderParams):
    """(field name, tensor) of the embedder's present leaves, in field order."""
    return [(f.name, getattr(p, f.name)) for f in dataclasses.fields(p)
            if getattr(p, f.name) is not None]


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
