"""Embedding weight norms across training checkpoints (counterpart of
`scripts/chk_ckpt_weights.py`):

    python -m adaface_tpu_torch.tools.chk_ckpt_weights 'logs/run/embeddings_gs-*.npz'

Native `.npz` checkpoints (globs expanded) in the order of the step in
their name (`gs-<n>`, else the first number); one line each, with every
placeholder's L2 norms of its random weights, basis vectors and bias, to
watch drift across iterations. Host only: no card is used.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
from typing import Optional, Sequence

import numpy as np


def step_of(path: str) -> int:
    """The training step a checkpoint's name holds (`gs-<n>`, else its first
    number, else 0)."""
    if not re.search(r"\d", path):
        return 0
    return int((re.search(r"gs-(\d+)", path) or re.search(r"(\d+)", path))[1])


def report(paths):
    from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager

    lines = []
    for path in sorted(paths, key=step_of):
        mgr = EmbeddingManager.load_native(path)
        parts = []
        for s, emb in mgr.embedders.items():
            norms = []
            for f in ("basis_rand_weights", "basis_vecs", "bias"):
                v = getattr(emb, f)
                if v is not None:
                    norms.append(f"{f.split('_')[-1]}={np.linalg.norm(v.numpy()):.3f}")
            parts.append(f"{s}({', '.join(norms)})")
        lines.append(f"{os.path.basename(path)}: {'  '.join(parts)}")
        print(lines[-1])
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("inputs", nargs="+")
    a = p.parse_args(argv)
    paths = []
    for item in a.inputs:
        paths.extend(glob.glob(item) if any(c in item for c in "*?[") else [item])
    report(paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
