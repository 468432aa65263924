"""Average embedding checkpoints across training iterations (counterpart of
`scripts/avgemb.py`, stochastic weight averaging):

    python -m adaface_tpu_torch.tools.avgemb 'logs/run/embeddings_gs-*.npz' \\
        --last_n 5 --out avg.npz

Inputs are native `.npz` files or globs, sorted by modification time;
`--last_n` keeps the newest N. Each of the five static fields is averaged
over the checkpoints that have it (numpy's float32 mean, as the JAX script
takes it); the first checkpoint's placeholders and header are kept. Host
only: no card is used.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

FIELDS = ("basis_rand_weights", "basis_comm_weights", "basis_vecs", "pre_vecs", "bias")


def average(paths, out_path):
    from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
    from adaface_tpu_torch.personalization.static_embedding import StaticEmbedderParams

    mgrs = [EmbeddingManager.load_native(p) for p in paths]
    base = mgrs[0]
    for s in base.placeholders:
        vals = {}
        for f in FIELDS:
            arrs = [getattr(m.embedders[s], f) for m in mgrs
                    if getattr(m.embedders[s], f) is not None]
            vals[f] = (torch.from_numpy(np.mean([a.numpy() for a in arrs], axis=0))
                       if arrs else None)
        base.embedders[s] = StaticEmbedderParams(**vals)
    base.save_native(out_path)
    print(f"averaged {len(paths)} ckpts -> {out_path}")
    return base


def expand(items):
    """The paths of `items` (globs expanded), sorted by modification time."""
    paths = []
    for item in items:
        paths.extend(glob.glob(item) if any(c in item for c in "*?[") else [item])
    return sorted(paths, key=os.path.getmtime)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("inputs", nargs="+",
                   help="checkpoints or a glob like 'logs/run/embeddings_gs-*.npz'")
    p.add_argument("--out", required=True)
    p.add_argument("--last_n", type=int, default=0, help="use only the N newest checkpoints")
    a = p.parse_args(argv)
    paths = expand(a.inputs)
    if a.last_n > 0:
        paths = paths[-a.last_n:]
    average(paths, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
