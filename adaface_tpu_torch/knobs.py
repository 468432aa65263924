"""`ADAFACE_*` environment knobs (counterpart of `adaface_tpu/knobs.py`).

The port gives the JAX package's knobs the same names and meanings, and reads
them live, at call time, so a process can flip a knob between two calls:

- `ADAFACE_GN_MAX_ELEMS` (default 0): the largest per-image `N * C` slab that
  `ops.fused_norm.group_norm_silu` hands to the fused GroupNorm+SiLU kernel;
  0 keeps every site on the plain GroupNorm then SiLU.
- `ADAFACE_FUSED_FF` ("1" to enable): the UNet's non-capturing transformer
  blocks run `ops.fused_ff.ln_geglu_ff`, the fused LayerNorm + GEGLU
  feed-forward + residual kernel.

The port keeps no compiled-program cache, so it needs no `fingerprint()`.
"""

from __future__ import annotations

import os


def get(name: str, default=None):
    """Raw environment read, compared exactly as the JAX call sites do."""
    return os.environ.get(name, default)


def flag(name: str, default: bool = False) -> bool:
    """Boolean knob: unset -> default; "0", "" and "false" -> False; else True."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("0", "", "false", "False")


def intval(name: str, default) -> int:
    return int(os.environ.get(name, default))
