"""Batch image resizing (counterpart of `scripts/resize_imgs.py`):

    python -m adaface_tpu_torch.tools.resize_imgs SRC_DIR DST_DIR --size 512

Every `.jpg`, `.jpeg`, `.png` and `.webp` of SRC_DIR (sorted) is scaled so
that its short side is `--size` (each side `round(side * scale)`) with
Pillow's LANCZOS, as `data/resample.py` computes it bit for bit, and saved
under the same name in DST_DIR. PNGs are read and written by the port's
codec (`data/png.py`), JPEGs read by the port's decoder (`data/jpeg.py`):
no PIL is loaded for them. Every destination that is not a PNG (`.jpg`,
`.jpeg`, `.webp`) is written through PIL; where PIL is missing and such a
destination exists, the tool exits before it writes anything, naming them.
Host only: no card is used.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def resized_size(w: int, h: int, size: int):
    scale = size / min(w, h)
    return round(w * scale), round(h * scale)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from adaface_tpu_torch.data import png
    from adaface_tpu_torch.data.resample import resize

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--size", type=int, default=512, help="target short-side length")
    opt = p.parse_args(argv)
    names = [n for n in sorted(os.listdir(opt.src))
             if n.lower().endswith((".jpg", ".jpeg", ".png", ".webp"))]
    via_pil = [n for n in names if not n.lower().endswith(".png")]
    if via_pil:
        try:
            import PIL  # noqa: F401
        except ImportError:
            raise SystemExit(
                f"resize_imgs: {len(via_pil)} destination(s) are not PNGs "
                f"({', '.join(via_pil[:3])}{', ...' if len(via_pil) > 3 else ''}): the port "
                "writes PNGs only, and JPEG or WebP files need PIL, which is not installed; "
                "nothing was written") from None
    os.makedirs(opt.dst, exist_ok=True)
    n = 0
    for name in names:
        img = png.load_image(os.path.join(opt.src, name), "RGB")
        h, w = img.shape[:2]
        out = resize(img, resized_size(w, h, opt.size), "lanczos")
        dst = os.path.join(opt.dst, name)
        if name.lower().endswith(".png"):
            png.write(dst, out)
        else:
            from PIL import Image

            Image.fromarray(out).save(dst)
        n += 1
    print(f"resized {n} images -> {opt.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
