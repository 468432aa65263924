"""Exponential moving average of the trainable embedders (counterpart of
`adaface_tpu/training/ema.py`, the reference's LitEma; off by default).

LitEma's warm-up: the effective decay is min(decay, (1 + n) / (10 + n)),
with n the update count after this update's increment, so early updates
average aggressively. The shadow is a dict placeholder -> embedder holding
fp32 copies of the live leaves.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch

from adaface_tpu_torch.personalization.static_embedding import embedder_leaves


class EmaState(NamedTuple):
    shadow: Dict[str, object]  # placeholder -> embedder of detached copies
    num_updates: int


def _copy(embedders: Dict[str, object]) -> Dict[str, object]:
    return {s: dataclasses.replace(e, **{n: t.detach().clone() for n, t in embedder_leaves(e)})
            for s, e in embedders.items()}


def ema_init(embedders: Dict[str, object]) -> EmaState:
    return EmaState(shadow=_copy(embedders), num_updates=0)


@torch.no_grad()
def ema_update(state: EmaState, embedders: Dict[str, object],
               decay: float = 0.9999) -> EmaState:
    """shadow <- shadow - (1 - d) (shadow - live), d = min(decay, (1+n)/(10+n))
    with n the new update count, d and 1 - d taken in fp32 as the JAX package
    takes them (the shadow's tensors are updated in place)."""
    n = state.num_updates + 1
    d = np.minimum(np.float32(decay), np.float32(1.0 + n) / np.float32(10.0 + n))
    w = float(np.float32(1.0) - d)
    for s, e in state.shadow.items():
        for (_, sh), (_, live) in zip(embedder_leaves(e), embedder_leaves(embedders[s])):
            sh.sub_(w * (sh - live.detach()))
    return EmaState(shadow=state.shadow, num_updates=n)


def ema_params(state: EmaState) -> Dict[str, object]:
    """The shadow embedders (use inside `ema_scope` at eval)."""
    return state.shadow


@contextlib.contextmanager
def ema_scope(holder, attr: str, state: EmaState, context: str = ""):
    """Swap `holder.<attr>` for the EMA shadow inside the block, restoring the
    live value after it:

        with ema_scope(trainer.mgr, "embedders", trainer.ema_state, "sampling"):
            pipe.generate(...)
    """
    if state is None:
        yield
        return
    live = getattr(holder, attr)
    setattr(holder, attr, ema_params(state))
    if context:
        print(f"{context}: switched to EMA weights")
    try:
        yield
    finally:
        setattr(holder, attr, live)
        if context:
            print(f"{context}: restored training weights")
