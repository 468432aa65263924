"""Merge per-subject embedding checkpoints into one (counterpart of
`scripts/merge_embeddings.py`):

    python -m adaface_tpu_torch.tools.merge_embeddings a.npz b.pt --out merged.npz

Inputs are native `.npz` or reference `.pt` checkpoints, read in order.
Every placeholder is renumbered from token id 49408 in input order; one
whose string is already taken is renamed `z2`, `z3`, ... The output is a
native `.npz`. Host only: no card is used.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def merge(paths, out_path):
    from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager

    merged = EmbeddingManager()
    next_id = 49408
    for path in paths:
        if path.endswith(".npz"):
            src = EmbeddingManager.load_native(path)
        else:
            src = EmbeddingManager()
            src.load_reference_checkpoint(path)
        for s, info in src.placeholders.items():
            target = s
            n = 2
            while target in merged.placeholders:
                target = f"{s}{n}"
                n += 1
            if target != s:
                print(f"{path}: {s} -> {target} (collision)")
            info.string = target
            info.token_id = next_id
            next_id += 1
            merged.placeholders[target] = info
            merged.embedders[target] = src.embedders[s]
            merged.emb_global_scale_scores[target] = src.emb_global_scale_scores.get(s, 0.0)
    merged.save_native(out_path)
    print(f"merged {len(merged.placeholders)} placeholders -> {out_path}")
    return merged


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("inputs", nargs="+")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    merge(a.inputs, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
