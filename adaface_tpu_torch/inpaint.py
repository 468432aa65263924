"""Masked inpainting CLI of the port (counterpart of `scripts/inpaint.py`):

    python -m adaface_tpu_torch.inpaint --init_img img.png --mask mask.png \\
        --prompt "a z wearing a hat" --out outputs/inpaint

The options of `img2img`, with `--mask` required: the region outside the
mask stays pinned to the noised init latent at every DDIM step
(`img2img.inpaint`).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from adaface_tpu_torch.img2img import main as img2img_main
from adaface_tpu_torch.img2img import parse_args


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    opt = parse_args(argv)
    if not opt.mask:
        raise SystemExit("inpaint requires --mask (use adaface_tpu_torch.img2img for the "
                         "whole image)")
    return img2img_main(device=device, opt=opt)


if __name__ == "__main__":
    sys.exit(main())
