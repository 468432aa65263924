"""Pillow's `Image.resize` of 8-bit images in numpy, so that the port resizes
where PIL is missing (the card's machine has none).

It follows Pillow's `Resample.c`: a separable filter (bilinear support 1,
bicubic 2 with a = -0.5, lanczos 3: sinc(x) sinc(x / 3)) stretched by the
scale when reducing (antialias); per output pixel the taps from
int(centre - support + 0.5) to int(centre + support + 0.5), clipped to the
image, their weights normalised to sum 1 in float64 and then turned into
fixed point with 22 fraction bits (rounded half away from zero); each pass
sums in integers from 2^21 and clips to 0..255 (`clip8`), the horizontal
pass before the vertical one, with the uint8 clip between them. A pass whose
size does not change is skipped; same size both ways is a copy. NEAREST is
Pillow's scaling affine: the source index walks from in / out / 2 in steps
of in / out, summed in float64 and truncated.
Modes: "L" ([H, W]) and "RGB" ([H, W, 3]) uint8, each channel on its own.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 22


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore", divide="ignore"):
        px = x * math.pi
        return np.where(x == 0.0, 1.0, np.sin(px) / px)


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3), 0.0)


FILTERS = {"bilinear": (1.0, _bilinear), "bicubic": (2.0, _bicubic),
           "lanczos": (3.0, _lanczos)}


def coefficients(in_size: int, out_size: int, resample: str
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(first tap [out], fixed-point weights [out, ksize] int64, zero past
    each pixel's taps) of one pass, as Pillow's `precompute_coeffs` and
    `normalize_coeffs_8bpc` make them."""
    support, fn = FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support *= filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) cast truncates toward zero; negatives clip to 0 either way
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize)[None, :]
    w = fn((x + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(x < xmax[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    scaled = w * (1 << PRECISION_BITS)
    fixed = np.where(scaled < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return xmin, fixed.astype(np.int64)


def _pass(img: np.ndarray, out_size: int, resample: str, axis: int) -> np.ndarray:
    """One 8-bit pass along `axis` (1: horizontal, 0: vertical) of an
    [H, W, C] uint8 array."""
    in_size = img.shape[axis]
    xmin, k = coefficients(in_size, out_size, resample)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # [in, other, C]
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)
        acc += src[idx] * k[:, j, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255)
    out = np.where(acc >= (255 << PRECISION_BITS), 255, np.where(acc <= 0, 0, out))
    return np.moveaxis(out.astype(np.uint8), 0, axis)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output pixel as Pillow's scaling affine walks
    it: x = a / 2, then += a (a = in / out) in float64, truncated; so the
    sum's rounding, not (i + 0.5) a, decides at exact halves."""
    a = in_size / out_size
    xo = np.empty(out_size, np.float64)
    acc = a * 0.5
    for i in range(out_size):
        xo[i] = acc
        acc += a
    return np.minimum(xo.astype(np.int64), in_size - 1)


def nearest(img: np.ndarray, size_wh) -> np.ndarray:
    """Pillow's NEAREST resize."""
    w, h = size_wh
    return img[_nearest_index(img.shape[0], h)][:, _nearest_index(img.shape[1], w)]


def resize(img: np.ndarray, size_wh, resample: str = "bicubic") -> np.ndarray:
    """`Image.fromarray(img).resize(size_wh, <resample>)` of a uint8 [H, W]
    or [H, W, 3] array: "nearest", "bilinear", "bicubic" (Pillow's default)
    or "lanczos"."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"an 8-bit [H, W] or [H, W, C] image, not {img.dtype} {img.shape}")
    w, h = (int(v) for v in size_wh)
    if (h, w) == img.shape[:2]:
        return img.copy()
    if resample == "nearest":
        return np.ascontiguousarray(nearest(img, (w, h)))
    if resample not in FILTERS:
        raise ValueError(f"unknown resample filter {resample!r}")
    x = img[..., None] if img.ndim == 2 else img
    if w != x.shape[1]:
        x = _pass(x, w, resample, axis=1)
    if h != x.shape[0]:
        x = _pass(x, h, resample, axis=0)
    return np.ascontiguousarray(x[..., 0] if img.ndim == 2 else x)
