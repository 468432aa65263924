"""Generate `*_mask.png` foreground masks for subject folders (counterpart
of `scripts/gen_face_masks.py`):

    python -m adaface_tpu_torch.tools.gen_face_masks <dir> [<dir> ...] \\
        [--precise --parsing_ckpt 79999_iter.pth [--route]] \\
        [--use_detector --detector {scrfd,retinaface}]

- default: a centred ellipse (subject-crop datasets);
- `--use_detector`: an ellipse grown from the biggest detected face's box
  (by area; `bbox_to_mask`, centre shifted up by 0.08 of the box height);
  "no face" prints and the image is skipped. SCRFD-10G has seeded weights
  (JAX has no SCRFD reader either); RetinaFace reads `RETINAFACE_PT` (a
  `mobilenet0.25_Final.pth`) where it exists, else seeded weights;
- `--precise`: BiSeNet face parsing (`--parsing_ckpt`, a face-parsing
  `79999_iter.pth`; a path given but missing exits; seeded weights without
  one) at `--parsing_size`; with `--route`, images of 9 or fewer parts move
  to `<folder>_trash` and of 18 or more to `<folder>_inspect`, beside the
  folder.

An existing mask is kept unless `--overwrite`. The networks run on the CUDA
card; `--device cpu` (or `main(..., device="cpu")`) runs them on the CPU.
Images are read and masks written by the port's PNG codec (`data/png.py`):
with PNGs no PIL is loaded: the resizes are PIL's filters as
`data/resample.py` computes them, bit for bit. Seeded weights are drawn from torch
seeds where the JAX script draws from PRNGKey(0): same laws, other numbers.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from adaface_tpu_torch.data import png
from adaface_tpu_torch.device import resolve_device
from adaface_tpu_torch.evaluation.eval_utils import list_image_files


def bbox_to_mask(shape, bbox, landmarks=None, grow=(0.35, 0.55)) -> np.ndarray:
    """Elliptical mask around the face box, grown wider and taller to cover
    hair and chin (grow = fractional margins); the landmarks are unused."""
    h, w = shape[:2]
    x1, y1, x2, y2 = bbox
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    rx = (x2 - x1) / 2 * (1 + grow[0])
    ry = (y2 - y1) / 2 * (1 + grow[1])
    cy -= (y2 - y1) * 0.08  # shift up a bit toward the hairline
    yy, xx = np.mgrid[0:h, 0:w]
    m = (((xx - cx) / max(rx, 1)) ** 2 + ((yy - cy) / max(ry, 1)) ** 2) <= 1.0
    return (m * 255).astype(np.uint8)


def pil_resize(img: np.ndarray, size_wh, resample: str) -> np.ndarray:
    """PIL's `Image.resize(size_wh, resample)` ("bilinear" or "nearest") of
    a uint8 image, by `data/resample.py`'s copy of it (bit for bit; no PIL);
    at its own size a copy."""
    from adaface_tpu_torch.data.resample import resize

    return resize(img, tuple(size_wh), resample)


def make_parser(opt, dev: torch.device):
    """parse(img uint8 [H, W, 3]) -> (mask uint8 [H, W], parts count)."""
    from adaface_tpu_torch.models.bisenet import init_bisenet, parsing_to_mask, preprocess

    if opt.parsing_ckpt:
        # a given but missing checkpoint is a hard error: random weights
        # would feed garbage parts counts into the destructive --route moves
        if not os.path.exists(opt.parsing_ckpt):
            raise SystemExit(f"--parsing_ckpt not found: {opt.parsing_ckpt}")
        from adaface_tpu_torch.interop.bisenet import load_bisenet

        model = load_bisenet(opt.parsing_ckpt, dev)
    else:
        print("NOTE: no --parsing_ckpt; random BiSeNet weights (smoke) — "
              "masks are architecture-real but untrained")
        model = init_bisenet(0, dev)

    @torch.inference_mode()
    def parse(img: np.ndarray):
        im = pil_resize(img, (opt.parsing_size, opt.parsing_size), "bilinear")
        logits = model(preprocess(torch.from_numpy(im[None]).to(dev)))
        mask, parts = parsing_to_mask(logits.argmax(dim=-1))
        m = pil_resize(mask[0].cpu().numpy(), (img.shape[1], img.shape[0]), "nearest")
        return m, int(parts[0])

    return parse


def make_detector(opt, dev: torch.device):
    """The `detect_fn` that `--detector` names."""
    if opt.detector == "scrfd":
        from adaface_tpu_torch.models.scrfd import SCRFDDetector, init_scrfd

        model = init_scrfd(0, device=dev)
        print("NOTE: SCRFD with synthetic weights (smoke) — boxes are "
              "architecture-real but untrained")
        return SCRFDDetector(model, score_thresh=opt.score_thresh)
    from adaface_tpu_torch.models.retinaface import (
        RetinaFace,
        RetinaFaceDetector,
        init_retinaface,
        map_retinaface_torch_params,
    )

    weights_path = os.environ.get("RETINAFACE_PT")
    if weights_path and os.path.exists(weights_path):
        from adaface_tpu_torch.interop.torch_pickle import load_torch_checkpoint
        from adaface_tpu_torch.pipeline import build_loaded

        sd = load_torch_checkpoint(weights_path)
        model = build_loaded(RetinaFace, map_retinaface_torch_params(sd.get("state_dict", sd)),
                             dev)
    else:
        print("NOTE: no RETINAFACE_PT weights; random detector (smoke)")
        model = init_retinaface(0, dev)
    return RetinaFaceDetector(model, score_thresh=opt.score_thresh)


def _precise(opt, dev) -> int:
    parse = make_parser(opt, dev)
    for folder in opt.folders:
        n = n_trash = n_inspect = 0
        for p in list_image_files(folder):
            out = os.path.splitext(p)[0] + "_mask.png"
            if os.path.exists(out) and not opt.overwrite:
                continue
            mask, parts = parse(png.load_image(p, "RGB"))
            # parts-count routing: too few parts is a bad image, too many
            # needs inspection
            if opt.route and (parts <= 9 or parts >= 18):
                dest = folder + ("_trash" if parts <= 9 else "_inspect")
                os.makedirs(dest, exist_ok=True)
                os.rename(p, os.path.join(dest, os.path.basename(p)))
                if parts <= 9:
                    n_trash += 1
                else:
                    n_inspect += 1
                continue
            png.write(out, mask)
            n += 1
        print(f"{folder}: wrote {n} masks (trash {n_trash}, inspect {n_inspect})")
    return 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("folders", nargs="+")
    p.add_argument("--use_detector", action="store_true")
    p.add_argument("--detector", choices=["scrfd", "retinaface"], default="scrfd",
                   help="scrfd = antelopev2 parity (the reference's training-time detector)")
    p.add_argument("--score_thresh", type=float, default=0.5)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--precise", action="store_true",
                   help="BiSeNet face-parsing masks instead of the detector ellipse")
    p.add_argument("--parsing_ckpt", type=str, default=None,
                   help="face-parsing .pth (e.g. 79999_iter.pth)")
    p.add_argument("--parsing_size", type=int, default=512)
    p.add_argument("--route", action="store_true",
                   help="move <=9-part images to *_trash and >=18-part to *_inspect")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the networks (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    """Write the masks as the options say. `argv` defaults to the command
    line; `device` overrides `--device`."""
    opt = parse_args(argv)
    dev = device if device is not None else opt.device
    if opt.precise:
        return _precise(opt, resolve_device(dev))
    detect = make_detector(opt, resolve_device(dev)) if opt.use_detector else None
    for folder in opt.folders:
        n = 0
        for p in list_image_files(folder):
            out = os.path.splitext(p)[0] + "_mask.png"
            if os.path.exists(out) and not opt.overwrite:
                continue
            img = png.load_image(p, "RGB")
            if detect is not None:
                faces = detect(img)
                if not faces:
                    print(f"no face: {p}")
                    continue
                bbox, lm, _ = max(faces, key=lambda f: (f[0][2] - f[0][0]) * (f[0][3] - f[0][1]))
                mask = bbox_to_mask(img.shape, bbox, lm)
            else:
                # centred default ellipse (subject-crop datasets)
                h, w = img.shape[:2]
                mask = bbox_to_mask(img.shape, (w * 0.2, h * 0.12, w * 0.8, h * 0.88))
            png.write(out, mask)
            n += 1
        print(f"{folder}: wrote {n} masks")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
