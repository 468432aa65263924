"""Generate DreamBooth class-regularization images (counterpart of
`scripts/gen_db_reg.py`, the reference's `scripts/gen-db-reg.sh`):

    python -m adaface_tpu_torch.tools.gen_db_reg --class_prompt "a photo of a person" \\
        --out reg/person --num_images 200 --ckpt sd-v1-5.ckpt

It calls the port's `txt2img.main` in-process in batches of
`min(--n_samples, images left)`, batch b seeded `--seed + b` into `<out>/bNNNN/`,
then moves every sample up into `<out>` as `reg_{idx:05}.png`, batch by
batch in order (the grids stay behind), so that the folder is a plain image
folder for `train --dreambooth --reg_data_root`. The images are PNGs (the
port's txt2img; JAX names them `.jpg`). It runs on the CUDA card; `--device cpu` (or
`main(..., device="cpu")`) runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--class_prompt", required=True, help='e.g. "a photo of a person"')
    p.add_argument("--out", required=True, help="reg image folder")
    p.add_argument("--num_images", type=int, default=200)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def batch_argvs(opt) -> List[List[str]]:
    """The txt2img argv of each batch."""
    out, done, batch = [], 0, 0
    while done < opt.num_images:
        n = min(opt.n_samples, opt.num_images - done)
        argv = ["--prompt", opt.class_prompt, "--out", os.path.join(opt.out, f"b{batch:04}"),
                "--steps", str(opt.steps), "--size", str(opt.size),
                "--n_samples", str(n), "--seed", str(opt.seed + batch)]
        if opt.ckpt:
            argv += ["--ckpt", opt.ckpt]
        if opt.tiny:
            argv += ["--tiny"]
        out.append(argv)
        done += n
        batch += 1
    return out


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> int:
    """Generate as the options say. `argv` defaults to the command line;
    `device` overrides `--device`."""
    from adaface_tpu_torch import txt2img

    opt = parse_args(argv)
    device = device if device is not None else opt.device
    os.makedirs(opt.out, exist_ok=True)
    for argv2 in batch_argvs(opt):
        txt2img.main(argv2, device=device)
    # flatten: move the samples up so that the folder is a plain image folder
    idx = 0
    for root, dirs, files in os.walk(opt.out):
        dirs.sort()  # batch order (JAX walks them in the file system's order)
        if root == opt.out:
            continue
        for f in sorted(files):
            if f.endswith((".jpg", ".png")) and "grid" not in f:
                os.replace(os.path.join(root, f), os.path.join(opt.out, f"reg_{idx:05}.png"))
                idx += 1
    print(f"wrote {idx} class-regularization images to {opt.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
