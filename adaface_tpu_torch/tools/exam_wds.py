"""Inspect webdataset shards (counterpart of `scripts/exam_wds.py`):

    python -m adaface_tpu_torch.tools.exam_wds shard-000.tar --n 20 --dump /tmp/wds

It streams backgrounds from LAION-style tar shards through the port's
training compositor (`data/wds.BackgroundCompositor`: the same caption and
aspect filters, resize and crop), prints each accepted one and the pass
rate, and with `--dump` writes them as `bg_{i:04d}.png` through the port's
PNG codec (JAX writes JPEGs through PIL). Host only: no card is used.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from adaface_tpu_torch.data import png
    from adaface_tpu_torch.data.wds import BackgroundCompositor

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("shards", nargs="+")
    p.add_argument("--n", type=int, default=20, help="samples to examine")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--dump", type=str, default=None, help="save accepted backgrounds here")
    opt = p.parse_args(argv)

    comp = BackgroundCompositor(opt.shards, size=opt.size)
    if opt.dump:
        os.makedirs(opt.dump, exist_ok=True)
    accepted = 0
    for i in range(opt.n):
        out = comp.next_background()
        if out is None:
            print(f"stream exhausted after {i} draws")
            break
        img, caption = out
        accepted += 1
        print(f"[{i}] {img.shape} {caption[:100]!r}")
        if opt.dump:
            png.write(os.path.join(opt.dump, f"bg_{i:04d}.png"), img)
    print(f"{accepted}/{opt.n} backgrounds accepted (filters: {comp.rejected} rejected)"
          if hasattr(comp, "rejected") else f"{accepted}/{opt.n} accepted")
    return 0


if __name__ == "__main__":
    sys.exit(main())
