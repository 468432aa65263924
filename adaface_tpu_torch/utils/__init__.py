"""Small observability helpers (counterpart of `adaface_tpu/utils/__init__.py`)."""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn


def count_params(model_or_state, unit: float = 1e6) -> float:
    """Parameter count in `unit`s (millions by default) of an `nn.Module`
    or of a mapping (nested or flat) of tensors or arrays."""
    if isinstance(model_or_state, nn.Module):
        return sum(p.numel() for p in model_or_state.parameters()) / unit

    def leaves(tree):
        if isinstance(tree, Mapping):
            for v in tree.values():
                yield from leaves(v)
        elif tree is not None:
            yield tree

    return sum(int(np.prod(np.shape(x))) for x in leaves(model_or_state)) / unit


def calc_stats(name: str, x, verbose: bool = True) -> Tuple[float, float, float, float]:
    """(mean, std, min, max) of a tensor or array, the std the population one
    (ddof 0, as `jnp.std`), printed in the JAX helper's line format."""
    t = torch.as_tensor(x).detach()
    if not t.is_floating_point():
        t = t.float()
    stats = (t.mean(), t.std(correction=0), t.min(), t.max())
    stats = tuple(float(s) for s in stats)
    if verbose:
        print(f"{name}: shape={tuple(t.shape)} mean={stats[0]:.4f} std={stats[1]:.4f} "
              f"min={stats[2]:.4f} max={stats[3]:.4f}", flush=True)
    return stats
