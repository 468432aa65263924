"""Folder-pair face similarity (counterpart of `scripts/comparefaces.py`):

    python -m adaface_tpu_torch.tools.comparefaces <dir1> [<dir2>] [--self]

The mean pairwise cosine similarity of the biggest faces of two folders
(`evaluation/eval_utils.compare_face_folders`), or of a folder with itself
(`--self` or no second folder: the intra-subject upper bound), and the
counts of images without a face. The recognizer is
`face_app.default_face_app`'s, on the CUDA card unless `--device cpu` (or
`main(..., device="cpu")`).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    from adaface_tpu_torch.evaluation.eval_utils import compare_face_folders
    from adaface_tpu_torch.face_app import default_face_app

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("folder1")
    p.add_argument("folder2", nargs="?", default=None)
    p.add_argument("--self", dest="self_compare", action="store_true")
    p.add_argument("--device", type=str, default=None)
    a = p.parse_args(argv)
    app = default_face_app(device if device is not None else a.device)
    f2 = a.folder1 if (a.self_compare or a.folder2 is None) else a.folder2
    sim, nf1, nf2 = compare_face_folders(app.embed_image, a.folder1, f2)
    print(f"{a.folder1} vs {f2}: face sim {sim:.4f} (no-face: {nf1}/{nf2})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
