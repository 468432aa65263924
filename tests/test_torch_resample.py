"""`adaface_tpu_torch/data/resample.py` against Pillow, which the JAX scripts
resize with (the card's machine has no PIL):

- LANCZOS, BICUBIC, BILINEAR and NEAREST at up- and down-scales, RGB and L,
  bit for bit (max 0 levels); the trap, float weights with one final round
  instead of Pillow's 22-bit fixed point, differs from Pillow in some pixels
  (the share is printed);
- `txt2img.load_resized` (PIL's default bicubic) and `gen_face_masks`'s
  `pil_resize` (bilinear, nearest) against the PIL calls of the JAX scripts
  at sizes that resample;
- `tools/resize_imgs` end to end against `scripts/resize_imgs.py` on PNGs
  and a JPEG: the same files, byte for byte."""

import importlib.util
import os

import numpy as np
import pytest
from PIL import Image

from adaface_tpu_torch import txt2img
from adaface_tpu_torch.data import png, resample
from adaface_tpu_torch.tools import gen_face_masks, resize_imgs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIL_FILTERS = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
               "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}
# (input h, w) -> output (w, h): reductions (antialiased), enlargements, mixed
SIZES = [((64, 48), (17, 23)), ((64, 48), (128, 96)), ((300, 200), (133, 200)),
         ((37, 91), (91, 18)), ((96, 96), (512, 512)), ((600, 440), (512, 375))]


def _image(h, w, seed=0, gray=False):
    g = np.random.default_rng(seed)
    return g.integers(0, 256, (h, w) if gray else (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("filt", sorted(PIL_FILTERS))
@pytest.mark.parametrize("shape,size", SIZES)
def test_resize_equals_pillow_bit_for_bit(filt, shape, size):
    for gray in (False, True):
        img = _image(*shape, seed=shape[0], gray=gray)
        want = np.asarray(Image.fromarray(img).resize(size, PIL_FILTERS[filt]))
        got = resample.resize(img, size, filt)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.array_equal(got, want), (filt, shape, size, gray)


def _float_resize(img, size, filt):
    """The other choice: the same taps in float64, one round at the end."""
    x = img.astype(np.float64)
    for axis, n in ((1, size[0]), (0, size[1])):
        if x.shape[axis] == n:
            continue
        xmin, k = resample.coefficients(x.shape[axis], n, filt)
        w = k / float(1 << resample.PRECISION_BITS)
        src = np.moveaxis(x, axis, 0)
        acc = np.zeros((n,) + src.shape[1:])
        for j in range(k.shape[1]):
            acc += src[np.minimum(xmin + j, x.shape[axis] - 1)] * w[:, j, None, None]
        x = np.moveaxis(acc, 0, axis)
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def test_float_arithmetic_falls_outside(capsys):
    shares = {}
    for filt in ("lanczos", "bicubic", "bilinear"):
        off, total = 0, 0
        for shape, size in SIZES:
            img = _image(*shape, seed=shape[1])
            want = np.asarray(Image.fromarray(img).resize(size, PIL_FILTERS[filt]))
            d = np.abs(_float_resize(img, size, filt).astype(int) - want.astype(int))
            off += int((d > 0).sum())
            total += d.size
        shares[filt] = off / total
    with capsys.disabled():
        print("\nfloat weights, one final round: share of values off Pillow's "
              + ", ".join(f"{f} {s:.4%}" for f, s in shares.items()))
    assert all(s > 0 for s in shares.values()), shares


@pytest.mark.parametrize("shape", [(40, 56), (64, 64), (300, 200)])
def test_load_resized_equals_the_jax_scripts_pil_call(tmp_path, shape):
    img = _image(*shape, seed=7)
    path = str(tmp_path / "a.png")
    png.write(path, img)
    want = np.asarray(Image.open(path).convert("RGB").resize((64, 64)))
    assert np.array_equal(txt2img.load_resized(path, 64), want)
    gray = np.asarray(Image.open(path).convert("L").resize((48, 48)))
    assert np.array_equal(txt2img.load_resized(path, 48, "L"), gray)


@pytest.mark.parametrize("filt", ["bilinear", "nearest"])
def test_pil_resize_equals_pil(filt):
    img = _image(120, 90, seed=3)
    for size in ((100, 100), (45, 60), (512, 512)):
        want = np.array(Image.fromarray(img).resize(size, PIL_FILTERS[filt]))
        assert np.array_equal(gen_face_masks.pil_resize(img, size, filt), want)
    same = gen_face_masks.pil_resize(img, (90, 120), filt)
    assert np.array_equal(same, img) and same is not img


def _jax_resize_imgs():
    spec = importlib.util.spec_from_file_location(
        "jax_resize_imgs_script", os.path.join(ROOT, "scripts", "resize_imgs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_resize_imgs_equals_jax_script(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    for i, shape in enumerate([(300, 200), (64, 96), (512, 512), (700, 500)]):
        png.write(str(src / f"{i}.png"), _image(*shape, seed=i))
    Image.fromarray(_image(90, 130, seed=9)).save(src / "5.jpg", quality=90)
    (src / "notes.txt").write_text("skipped")
    jdst, tdst = tmp_path / "jax", tmp_path / "port"
    assert _jax_resize_imgs().main([str(src), str(jdst), "--size", "128"]) == 0
    jout = capsys.readouterr().out
    assert resize_imgs.main([str(src), str(tdst), "--size", "128"]) == 0
    tout = capsys.readouterr().out
    assert tout.replace(str(tdst), "<dst>") == jout.replace(str(jdst), "<dst>")
    assert sorted(os.listdir(tdst)) == sorted(os.listdir(jdst)) == \
        ["0.png", "1.png", "2.png", "3.png", "5.jpg"]
    for name in os.listdir(jdst):
        want = np.asarray(Image.open(jdst / name).convert("RGB"))
        got = np.asarray(Image.open(tdst / name).convert("RGB"))
        assert got.shape == want.shape and min(got.shape[:2]) == 128
        assert np.array_equal(got, want), name
    assert (tdst / "5.jpg").read_bytes() == (jdst / "5.jpg").read_bytes()


def test_resize_imgs_without_pil_refuses_jpeg_destinations_first(tmp_path, monkeypatch):
    """Where PIL is missing, a folder with a JPEG destination fails before
    anything is written, naming the gap; a PNG-only folder still resizes."""
    import sys

    src = tmp_path / "src"
    src.mkdir()
    png.write(str(src / "a.png"), _image(40, 60, seed=1))
    Image.fromarray(_image(30, 50, seed=2)).save(src / "b.jpg", quality=90)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit) as e:
        resize_imgs.main([str(src), str(tmp_path / "dst"), "--size", "20"])
    assert "b.jpg" in str(e.value) and "PIL" in str(e.value)
    assert not (tmp_path / "dst").exists()
    os.remove(src / "b.jpg")
    assert resize_imgs.main([str(src), str(tmp_path / "dst"), "--size", "20"]) == 0
    assert os.listdir(tmp_path / "dst") == ["a.png"]
