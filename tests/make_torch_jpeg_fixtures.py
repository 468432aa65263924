"""Writes the JPEG fixtures of the port's decoder (`adaface_tpu_torch/
data/jpeg.py`) with PIL: small seeded images under `tests/fixtures/jpeg/`,
one for each kind of input the decoder takes (sequential 4:2:0, 4:2:2 and
4:4:4, grey, Adobe RGB, optimised tables, progressive, restart intervals,
odd and narrow sizes), and `digests.json`: for each file, the SHA-256 of
PIL's decode, `np.asarray(Image.open(f).convert(mode))`, in RGB and L,
with its shape. `chip_smoke.py`'s `[jpeg]` phase holds the port's decode
against these digests on a machine without PIL;
`tests/test_torch_jpeg.py` checks that both PIL and the port still give
them.

    python tests/make_torch_jpeg_fixtures.py

The image makers `smooth` and `noise` serve the tests too.
"""

import hashlib
import io
import json
import os

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "jpeg")

# name -> (content, height, width, grey, Pillow's save options)
CASES = {
    "smooth_420_q95.jpg": ("smooth", 61, 47, False, dict(quality=95, subsampling=2)),
    "noise_420_q75.jpg": ("noise", 48, 64, False, dict(quality=75, subsampling=2)),
    "smooth_422_q50.jpg": ("smooth", 37, 53, False, dict(quality=50, subsampling=1)),
    "noise_444_q100.jpg": ("noise", 29, 33, False, dict(quality=100, subsampling=0)),
    "grey_q90.jpg": ("smooth", 45, 31, True, dict(quality=90)),
    "adobe_rgb.jpg": ("smooth", 40, 40, False, dict(quality=90, keep_rgb=True)),
    "optimized_420.jpg": ("noise", 36, 52, False, dict(quality=85, optimize=True)),
    "progressive_420.jpg": ("smooth", 64, 64, False, dict(quality=90, progressive=True)),
    "progressive_grey.jpg": ("noise", 33, 27, True, dict(quality=80, progressive=True)),
    "restart_rows.jpg": ("smooth", 50, 70, False, dict(quality=90, restart_marker_rows=1)),
    "restart_blocks.jpg": ("noise", 40, 44, False, dict(quality=90, restart_marker_blocks=5)),
    "one_pixel.jpg": ("noise", 1, 1, False, dict(quality=95)),
    "narrow_420.jpg": ("smooth", 20, 3, False, dict(quality=95, subsampling=2)),
}


def smooth(rng, h, w, c=3):
    """A photo-like image: crossed sinusoids, a soft disk and a little
    grain, [h, w, c] uint8."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    out = []
    for i in range(c):
        a = 128 + 70 * np.sin(xx / (7.0 + 3 * i) + i) * np.cos(yy / (11.0 - 2 * i) - i)
        a += 40 * (np.hypot(yy - h * 0.4, xx - w * 0.6) < min(h, w) * 0.3)
        out.append(a)
    a = np.stack(out, -1) + rng.normal(0, 3, (h, w, c))
    return np.clip(np.rint(a), 0, 255).astype(np.uint8)


def noise(rng, h, w, c=3):
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


def make(content, h, w, grey, seed):
    rng = np.random.default_rng(seed)
    a = (smooth if content == "smooth" else noise)(rng, h, w, 1 if grey else 3)
    return a[..., 0] if grey else a


def encode(a, **options) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", **options)
    return buf.getvalue()


def digest(px: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()


def pil_digests(path):
    from PIL import Image

    out = {}
    for mode in ("RGB", "L"):
        px = np.asarray(Image.open(path).convert(mode))
        out[mode] = {"sha256": digest(px), "shape": list(px.shape)}
    return out


def main():
    from PIL import features

    os.makedirs(FIXTURES, exist_ok=True)
    table = {}
    for i, (name, (content, h, w, grey, options)) in enumerate(sorted(CASES.items())):
        path = os.path.join(FIXTURES, name)
        with open(path, "wb") as f:
            f.write(encode(make(content, h, w, grey, seed=100 + i), **options))
        table[name] = pil_digests(path)
    table["_decoder"] = f"libjpeg-turbo {features.version('libjpeg_turbo')}"
    with open(os.path.join(FIXTURES, "digests.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(CASES)} fixtures and their digests to {FIXTURES}")


if __name__ == "__main__":
    main()
