"""Word and concept CLIP text-similarity probe (counterpart of
`scripts/text_sim_exp.py`):

    python -m adaface_tpu_torch.tools.text_sim_exp [--triplet A B C ...]

For each (a, b, c) triplet it prints cos(a, b), cos(a, c) and
cos(a, normalize(b + c)), on the projected sentence features and on the
normalised mean of the contextual token embeddings, through the port's
`evaluation/scorers.CLIPScorer`. Weights come from `CLIP_SCORER_PT` and the
tokenizer from `CLIP_VOCAB_JSON` / `CLIP_MERGES_TXT` (random tiny towers
and the hash tokenizer without them: the numbers then mean nothing). It
runs on the CUDA card; `--device cpu` (or `main(..., device="cpu")`) runs
it on the CPU. `triplet_cosines` returns the numbers.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

TRIPLETS = [
    ["camel", "giraffe", "cashmere"],
    ["snail", "ladybug", "winding"],
    ["dietitian", "pharmacist", "nutritious"],
    ["snake", "twisted", "gecko"],
    ["reflections of earth", "sphere", "civilization"],
    ["fear", "scream", "wolf"],
    ["snail", "table", "cake"],
    ["camel", "giraffe", "door"],
]


@torch.inference_mode()
def token_mean_feats(clip, words) -> np.ndarray:
    """Normalised mean contextual token embedding (before the projection),
    the reference's `get_text_features(..., get_token_emb=True)` arm."""
    ids = torch.as_tensor(np.asarray(clip.tokenizer(list(words))), dtype=torch.long,
                          device=clip.device)
    feats = clip.text(ids).float().mean(dim=1)
    return (feats / torch.linalg.norm(feats, dim=-1, keepdim=True)).cpu().numpy()


def triplet_cosines(clip, triplets) -> List[dict]:
    """Per triplet and arm ("sentence", "token_mean"): cos(a, b), cos(a, c)
    and cos(a, normalize(b + c)), in float64 from the fp32 features."""
    out = []
    for wa, wb, wc in triplets:
        row = {"triplet": (wa, wb, wc)}
        for arm in ("sentence", "token_mean"):
            if arm == "token_mean":
                fa, fb, fc = token_mean_feats(clip, [wa, wb, wc])
            else:
                fa, fb, fc = clip.get_text_features([wa, wb, wc]).cpu().numpy()
            fbc = fb + fc
            fbc = fbc / np.linalg.norm(fbc)
            row[arm] = (float(fa @ fb), float(fa @ fc), float(fa @ fbc))
        out.append(row)
    return out


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    """Print the triplets' cosines. `argv` defaults to the command line;
    `device` overrides `--device`."""
    from adaface_tpu_torch.evaluation.scorers import init_evaluators

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--triplet", nargs=3, action="append", default=None,
                   metavar=("A", "B", "C"), help="extra word triplets")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    opt = p.parse_args(argv)
    clip, _ = init_evaluators(device=device if device is not None else opt.device)
    for row in triplet_cosines(clip, TRIPLETS + (opt.triplet or [])):
        wa, wb, wc = row["triplet"]
        print(f"Triplet: '{wa}' vs '{wb}'\t'{wc}'")
        for arm in ("sentence", "token_mean"):
            ab, ac, abc = row[arm]
            print(f"'{wa}', '{wb}': {ab:.3f}, '{wa}', '{wc}': {ac:.3f}")
            print(f"'{wa}', '{wb}' + '{wc}': {abc:.3f}")
            print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
