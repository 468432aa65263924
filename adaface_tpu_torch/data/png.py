"""A small PNG codec on `zlib` and numpy, so the port reads and writes its
own images where PIL is missing.

- `encode` / `write`: 8-bit RGB ([H, W, 3]) or L ([H, W]) uint8 arrays,
  one IDAT chunk, every row under filter 0.
- `decode` / `read`: 8-bit, non-interlaced PNGs of color type 0 (L), 2
  (RGB), 4 (LA) and 6 (RGBA), with all five row filters. Other PNGs
  (palette, 16-bit, interlaced) raise `UnsupportedPNG`.
- `load_image(path_or_bytes, mode)`: "RGB" or "L" pixels the way PIL's
  `Image.open(...).convert(mode)` gives them, routed by the file's
  signature: PNGs through this codec, JPEGs through `data/jpeg.py`, and
  only then PIL (other formats, or a PNG or JPEG those refuse), imported
  only then. Where PIL is missing, such a file raises an ImportError that
  names the file and the feature; no substitute pixels are returned.

The conversions are PIL's: L and LA to RGB repeat the gray value, RGBA and
LA drop alpha, RGB to L is (19595 R + 38470 G + 7471 B + 2^15) >> 16. PNG is
lossless, so the arrays equal PIL's bit for bit.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class UnsupportedPNG(ValueError):
    """A PNG this codec does not decode (PIL still may)."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of an 8-bit [H, W] (L) or [H, W, 3] (RGB) array."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"encode takes uint8 [H, W] or [H, W, 3], got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode(img))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines with their filters undone: [h, stride] uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    data = data[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per byte of a pixel
            cur = line.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint64)
            cur = (cur % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            f, up = line.tolist(), prior.tolist()
            r = [0] * stride
            for x in range(stride):
                a = r[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                r[x] = (f[x] + pred) & 0xFF
            cur = np.asarray(r, np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def decode(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit non-interlaced PNG: [H, W] for gray, [H, W, C]
    (C 2, 3 or 4) otherwise."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG")
    pos, header, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise UnsupportedPNG(f"bit depth {depth}, color type {ctype}, interlace {interlace}")
    c = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return px.reshape(h, w) if c == 1 else px.reshape(h, w, c)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def convert(px: np.ndarray, mode: str) -> np.ndarray:
    """Decoded pixels as PIL's `convert(mode)` gives them, mode "RGB" or "L"."""
    if px.ndim == 2:
        px = px[..., None]
    gray = px.shape[2] <= 2  # L or LA
    if mode == "RGB":
        return np.repeat(px[..., :1], 3, axis=2) if gray else np.ascontiguousarray(px[..., :3])
    if mode == "L":
        if gray:
            return np.ascontiguousarray(px[..., 0])
        r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
        return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)
    raise ValueError(f"mode {mode!r}: RGB or L")


def load_image(src: Union[str, bytes], mode: str = "RGB") -> np.ndarray:
    """uint8 pixels of an image file (a path or its bytes) in `mode` ("RGB"
    or "L"), as PIL's `Image.open(src).convert(mode)` gives them: PNGs
    through this codec, JPEGs through `data/jpeg.py`, anything else (and a
    PNG or JPEG those refuse) through PIL."""
    from adaface_tpu_torch.data import jpeg

    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()
    feature = "neither a PNG nor a JPEG"
    if data.startswith(SIGNATURE):
        try:
            return convert(decode(data), mode)
        except UnsupportedPNG as e:
            feature = f"PNG of {e}"
    elif data.startswith(jpeg.SOI):
        try:
            return jpeg.load(data, mode)
        except jpeg.UnsupportedJPEG as e:
            feature = e.feature
    try:
        from PIL import Image
    except ImportError as e:
        name = "<image bytes>" if isinstance(src, (bytes, bytearray)) else src
        raise ImportError(f"{name}: {feature}, which the port's own decoders do not read, "
                          "and PIL is not installed") from e
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode), np.uint8)
