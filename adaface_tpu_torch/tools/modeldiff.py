"""Per-parameter differences of two checkpoints (counterpart of
`scripts/modeldiff.py`):

    python -m adaface_tpu_torch.tools.modeldiff a.ckpt b.ckpt --top 20

Inputs are native `.npz` embeddings or torch `.ckpt` / `.pt` state dicts,
read by the port's restricted loader (`interop/torch_pickle.py`: no pickled
code runs). For every name in both with the same shape it takes the L2 norm
of the difference in fp32 and its share of A's norm; the `--top` rows by
that share are printed, then the counts of names only in A or only in B.
Host only: no card is used.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def load_flat(path: str) -> dict:
    """name -> array (or tensor) of a checkpoint."""
    if path.endswith(".npz"):
        z = np.load(path)
        return {k: z[k] for k in z.files if k != "__header__"}
    from adaface_tpu_torch.interop.torch_pickle import load_torch_checkpoint, walk_stub_tree

    ckpt = load_torch_checkpoint(path)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    if isinstance(sd, dict) and all(torch.is_tensor(v) for v in sd.values()):
        return sd
    return walk_stub_tree(sd)


def _fp32(x) -> np.ndarray:
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def diff_rows(a: dict, b: dict):
    """(relative change, absolute change, name), largest share first."""
    rows = []
    for k in sorted(set(a) & set(b)):
        if not hasattr(a[k], "shape") or tuple(a[k].shape) != tuple(b[k].shape):
            continue
        d = float(np.linalg.norm(_fp32(a[k]) - _fp32(b[k])))
        base = float(np.linalg.norm(_fp32(a[k]))) + 1e-12
        rows.append((d / base, d, k))
    rows.sort(reverse=True)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ckpt_a")
    p.add_argument("ckpt_b")
    p.add_argument("--top", type=int, default=20)
    opt = p.parse_args(argv)
    a, b = load_flat(opt.ckpt_a), load_flat(opt.ckpt_b)
    for rel, d, k in diff_rows(a, b)[:opt.top]:
        print(f"rel {rel:8.4f}  abs {d:10.4f}  {k}")
    only_a, only_b = set(a) - set(b), set(b) - set(a)
    if only_a:
        print(f"only in A: {len(only_a)} keys")
    if only_b:
        print(f"only in B: {len(only_b)} keys")
    return 0


if __name__ == "__main__":
    sys.exit(main())
