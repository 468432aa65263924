"""The reuse-init cache of compositional distillation (the host class
`CachedInits` of `adaface_tpu/training/teacher_filter.py`). The teacher
filter itself, which fills the cache with the best candidate's CFG
reconstruction, is not ported yet; until it is, the trainer's
`cached_inits` stays None, as the JAX trainer's does without a filter."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class CachedInits:
    """Per subject, one cached reconstruction with the iteration context it
    was made under; a later compositional iteration pops it and reuses it as
    x_start at mid-range t."""

    def __init__(self):
        self._store: Dict[str, dict] = {}

    def put(self, subject: str, x_start, t, **extra):
        """`extra` carries the iteration context: fg_mask, prompts,
        use_background_token, comp_init_fg_from_training_image, ..."""
        self._store[subject] = {"x_start": np.asarray(x_start), "t": np.asarray(t), **extra}

    def peek(self, subject: str) -> Optional[dict]:
        return self._store.get(subject)

    def pop(self, subject: str) -> Optional[dict]:
        return self._store.pop(subject, None)

    def __contains__(self, subject: str) -> bool:
        return subject in self._store
