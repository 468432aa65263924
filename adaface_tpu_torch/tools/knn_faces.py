"""Face-embedding kNN retrieval over image folders (counterpart of
`scripts/knn_faces.py`):

    python -m adaface_tpu_torch.tools.knn_faces --query q.png --gallery <dir> ... [-k 10]

Prints the `k` gallery images nearest the query's biggest face by cosine
similarity, best first, as `"{sim:.4f}  {path}"`. The recognizer is
`face_app.default_face_app`'s, on the CUDA card unless `--device cpu` (or
`main(..., device="cpu")`).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from adaface_tpu_torch.data import png
from adaface_tpu_torch.evaluation.eval_utils import list_image_files


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    from adaface_tpu_torch.face_app import default_face_app

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--query", required=True)
    p.add_argument("--gallery", nargs="+", required=True)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--device", type=str, default=None)
    opt = p.parse_args(argv)
    app = default_face_app(device if device is not None else opt.device)
    q = app.embed_image(png.load_image(opt.query, "RGB"))
    if q is None:
        raise SystemExit("no face in query image")
    entries = []
    for folder in opt.gallery:
        for path in list_image_files(folder):
            e = app.embed_image(png.load_image(path, "RGB"))
            if e is not None:
                entries.append((path, float(q @ e)))
    entries.sort(key=lambda x: -x[1])
    for path, s in entries[:opt.k]:
        print(f"{s:.4f}  {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
