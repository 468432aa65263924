"""The port's PNG codec (`adaface_tpu_torch/data/png.py`) against PIL.

- Round trip: random RGB and L arrays through `encode` / `decode` come back
  bit for bit, and PIL reads the port's files as the same arrays.
- Decode: PIL-written PNGs of color types 0, 2, 4 and 6 (PIL's adaptive
  row filters) equal PIL's arrays bit for bit, and so do files whose rows
  carry each of the five filters in turn (written here by hand, since PIL
  picks its own). `load_image(..., "RGB" / "L")` equals PIL's `convert`.
- Other formats (JPEG, a palette PNG) still go through PIL; the
  personalized dataset's loads equal PIL's."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from adaface_tpu_torch.data import png

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _smooth(rng, h, w, c):
    """An image with gradients and noise, so PIL's adaptive filter picks
    several row filters."""
    y, x = np.mgrid[0:h, 0:w]
    a = ((x * 3 + y * 5)[..., None] + rng.integers(0, 40, (h, w, c))) % 256
    a = a.astype(np.uint8)
    return a[..., 0] if c == 1 else a


def _pil_png(a, mode) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a, mode).save(buf, format="PNG")
    return buf.getvalue()


def _filtered_png(a: np.ndarray, ctype: int) -> bytes:
    """A PNG whose row y carries filter y % 5, written by hand."""
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else a.shape[2]
    rows = a.reshape(h, w * c).astype(np.int64)
    out = []
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        kind, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prior
        elif kind == 3:
            f = cur - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
            f = cur - pred
        out.append(bytes([kind]) + (f % 256).astype(np.uint8).tobytes())
        prior = cur
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(b"".join(out))) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(1, 1), (17, 23), (64, 48, 3), (5, 130, 3)])
def test_round_trip(shape, tmp_path):
    a = np.random.default_rng(len(shape) * 7 + shape[0]).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(png.decode(png.encode(a)), a)
    path = str(tmp_path / "a.png")
    png.write(path, a)
    np.testing.assert_array_equal(png.read(path), a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_decodes_pil_files_bit_for_bit(mode):
    rng = np.random.default_rng(MODES[mode])
    data = _pil_png(_smooth(rng, 37, 53, MODES[mode]), mode)
    np.testing.assert_array_equal(png.decode(data), np.asarray(Image.open(io.BytesIO(data))))
    for conv in ("RGB", "L"):
        np.testing.assert_array_equal(
            png.load_image(data, conv), np.asarray(Image.open(io.BytesIO(data)).convert(conv)),
            err_msg=f"{mode} -> {conv}")


@pytest.mark.parametrize("mode,ctype", [("L", 0), ("RGB", 2), ("LA", 4), ("RGBA", 6)])
def test_every_row_filter(mode, ctype):
    a = _smooth(np.random.default_rng(ctype), 15, 21, MODES[mode])
    data = _filtered_png(a, ctype)
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8])
    stride = 21 * MODES[mode] + 1
    assert {raw[y * stride] for y in range(15)} == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(png.decode(data), a)
    np.testing.assert_array_equal(png.decode(data), np.asarray(Image.open(io.BytesIO(data))))


def test_other_formats_go_through_pil(tmp_path):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
    jpg = str(tmp_path / "a.jpg")
    Image.fromarray(a).save(jpg, quality=90)
    np.testing.assert_array_equal(png.load_image(jpg, "RGB"), np.asarray(Image.open(jpg)))
    pal = str(tmp_path / "p.png")
    Image.fromarray(a).convert("P").save(pal)
    with pytest.raises(png.UnsupportedPNG):
        png.read(pal)
    np.testing.assert_array_equal(png.load_image(pal, "RGB"),
                                  np.asarray(Image.open(pal).convert("RGB")))


def test_dataset_loads_equal_pil(tmp_path):
    from adaface_tpu_torch.data.personalized import ImageRecord, PersonalizedDataset, SubjectSpec

    rng = np.random.default_rng(6)
    Image.fromarray(_smooth(rng, 40, 36, 3)).save(tmp_path / "0.png")
    Image.fromarray(_smooth(rng, 40, 36, 3)).save(tmp_path / "0_mask.png")  # an RGB mask
    ds = PersonalizedDataset([SubjectSpec("s", str(tmp_path))], size=32, seed=0)
    image, mask, has = ds._load(ImageRecord(str(tmp_path / "0.png"),
                                            str(tmp_path / "0_mask.png"), None, 0))
    assert has
    np.testing.assert_array_equal(image, np.asarray(Image.open(tmp_path / "0.png").convert("RGB")))
    np.testing.assert_array_equal(mask,
                                  np.asarray(Image.open(tmp_path / "0_mask.png").convert("L")))
