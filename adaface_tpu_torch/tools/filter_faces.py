"""Dataset curation: move low-face-similarity and faceless images out of a
subject folder (counterpart of `scripts/filter_faces.py`):

    python -m adaface_tpu_torch.tools.filter_faces <dir> [<dir> ...] \\
        [--threshold 0.65] [--dry_run]

Each image's biggest face is embedded (`face_app.default_face_app`: the
IResNet-100 of `ARCFACE_ONNX` where it exists, else the tiny random
recognizer), its cosine similarity to the folder's mean taken, and images
below `--threshold` or without a face move into `<dir>/trash`, with their
`_mask.png` and `.txt` companions. The recognizer runs on the CUDA card;
`--device cpu` (or `main(..., device="cpu")`) runs it on the CPU. Images are
read by `data/png.load_image` (PNGs and JPEGs without PIL).
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional, Sequence

import numpy as np

from adaface_tpu_torch.data import png
from adaface_tpu_torch.evaluation.eval_utils import list_image_files


def filter_folder(face_embed_fn, folder: str, threshold: float = 0.65,
                  dry_run: bool = False):
    """The paths moved (faceless first, then those under `threshold`)."""
    paths = list_image_files(folder)
    embs, keep_paths, faceless = [], [], []
    for p in paths:
        e = face_embed_fn(png.load_image(p, "RGB"))
        if e is None:
            faceless.append(p)
        else:
            embs.append(np.asarray(e, np.float32))
            keep_paths.append(p)

    moved = list(faceless)
    if embs:
        mat = np.stack(embs)
        mat = mat / np.linalg.norm(mat, axis=-1, keepdims=True)
        mean = mat.mean(axis=0)
        mean = mean / (np.linalg.norm(mean) + 1e-12)
        sims = mat @ mean
        for p, s in zip(keep_paths, sims):
            if s < threshold:
                moved.append(p)
                print(f"low sim {s:.3f}: {os.path.basename(p)}")

    trash = os.path.join(folder, "trash")
    if not dry_run and moved:
        os.makedirs(trash, exist_ok=True)
        for p in moved:
            shutil.move(p, os.path.join(trash, os.path.basename(p)))
            stem = os.path.splitext(p)[0]
            for extra in (stem + "_mask.png", stem + ".txt"):
                if os.path.exists(extra):
                    shutil.move(extra, os.path.join(trash, os.path.basename(extra)))
    print(f"{folder}: kept {len(paths) - len(moved)}/{len(paths)}, "
          f"moved {len(moved)} ({len(faceless)} faceless)")
    return moved


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    from adaface_tpu_torch.face_app import default_face_app

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("folders", nargs="+")
    p.add_argument("--threshold", type=float, default=0.65)
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--device", type=str, default=None)
    a = p.parse_args(argv)
    app = default_face_app(device if device is not None else a.device)
    for folder in a.folders:
        filter_folder(app.embed_image, folder, a.threshold, a.dry_run)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
