"""The port's JPEG decoder (`adaface_tpu_torch/data/jpeg.py`) against
Pillow's decode, `np.asarray(Image.open(f).convert(mode))`, bit for bit:

- a matrix of seeded smooth and noise images written by PIL in-process
  (qualities 50-100 at each subsampling, grey, Adobe RGB, optimised tables,
  progressive, restart intervals, odd and narrow sizes), in RGB and L;
- the files it refuses (`UnsupportedJPEG`), PIL taking them where it
  imports, and the named ImportError where it does not;
- the traps: plain upsampling, a float IDCT and float colour conversion each
  fall outside bit equality;
- the committed fixtures (`tests/make_torch_jpeg_fixtures.py`) still decode
  to their digests through PIL and the port;
- JAX's `PersonalizedDataset` items from a JPEG subject folder equal the
  port's with PIL blocked for the port, and the port's dataset keeps each
  decoded image until the file changes.
"""

import functools
import io
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from adaface_tpu_torch.data import jpeg, png
from make_torch_jpeg_fixtures import FIXTURES, digest, encode, make

SIZES = [(1, 1), (7, 13), (37, 53), (129, 65)]
OPTIONS = {f"q{q}_ss{ss}": dict(quality=q, subsampling=ss)
           for q in (50, 75, 95, 100) for ss in (0, 1, 2)}
OPTIONS.update({
    "grey": dict(quality=90, grey=True),
    "keep_rgb": dict(quality=90, keep_rgb=True),
    "optimize": dict(quality=90, optimize=True),
    "progressive": dict(quality=90, progressive=True),
    "progressive_grey": dict(quality=90, progressive=True, grey=True),
    "restart_rows": dict(quality=90, restart_marker_rows=1),
    "restart_blocks": dict(quality=90, restart_marker_blocks=3),
})


def _file(content, hw, option, seed=0):
    options = dict(OPTIONS[option])
    grey = options.pop("grey", False)
    return encode(make(content, *hw, grey, seed), **options)


def _pil(data, mode):
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode))


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("content", ["smooth", "noise"])
def test_decode_equals_pil(content, hw, option):
    data = _file(content, hw, option, seed=hw[0] * 1000 + hw[1])
    for mode in ("RGB", "L"):
        got, want = jpeg.load(data, mode), _pil(data, mode)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(png.load_image(data, mode), want)


def test_markers_of_the_matrix_are_what_they_claim():
    """The options reach the decoder's branches: Adobe without JFIF, SOF2,
    DRI with RSTn, and the optimised tables differ from the standard ones."""
    a = make("smooth", 64, 64, False, 1)
    rgb = encode(a, quality=90, keep_rgb=True)
    assert b"Adobe" in rgb and b"JFIF" not in rgb
    prog = encode(a, quality=90, progressive=True)
    assert b"\xff\xc2" in prog and prog.count(b"\xff\xda") > 5
    rst = encode(a, quality=90, restart_marker_rows=1)
    assert b"\xff\xdd" in rst and b"\xff\xd0" in rst and b"\xff\xd2" in rst
    dht = lambda d: d[d.index(b"\xff\xc4"):d.index(b"\xff\xda")]  # noqa: E731
    assert dht(encode(a, quality=90, optimize=True)) != dht(encode(a, quality=90))


def test_load_image_routes_by_signature(tmp_path):
    data = _file("smooth", (37, 53), "q75_ss2")
    path = tmp_path / "actually_a_jpeg.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(png.load_image(str(path), "RGB"), _pil(data, "RGB"))
    np.testing.assert_array_equal(png.load_image(bytearray(data), "L"), _pil(data, "L"))


# ------------------------------------------------------------------ refusals

def _patched(data: bytes, marker: bytes, offset: int = 0, value: bytes = b"") -> bytes:
    """data with the SOF0 marker replaced by `marker`, or one byte of its
    header (`offset` past the marker) set to `value`."""
    i = data.index(b"\xff\xc0")
    if not value:
        return data[:i] + marker + data[i + 2:]
    return data[:i + offset] + value + data[i + offset + 1:]


def _without_last_scan(data: bytes) -> bytes:
    i = data.rindex(b"\xff\xda")
    return data[:i] + b"\xff\xd9"


def _cmyk() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(make("smooth", 24, 24, False, 2)).convert("CMYK").save(buf, "JPEG")
    return buf.getvalue()


BASE = functools.partial(_file, "smooth", (40, 48), "q75_ss2")
REFUSED = {
    "arithmetic": (lambda: _patched(BASE(), b"\xff\xc9"), "arithmetic-coded JPEG"),
    "lossless": (lambda: _patched(BASE(), b"\xff\xc3"), "lossless JPEG"),
    "hierarchical": (lambda: _patched(BASE(), b"\xff\xc5"), "hierarchical JPEG"),
    "12-bit": (lambda: _patched(BASE(), b"", 4, b"\x0c"), "12-bit samples"),
    "cmyk": (_cmyk, "four-component JPEG (CMYK or YCCK)"),
    "4:1:1": (lambda: _patched(BASE(), b"", 11, b"\x41"), "chroma sampling other than"),
    "progressive_unsent_bits": (
        lambda: _without_last_scan(_file("smooth", (40, 48), "progressive")),
        "progressive JPEG whose scans leave coefficient bits unsent"),
    "truncated": (lambda: BASE()[:len(BASE()) // 2], "truncated JPEG"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_files(case, tmp_path, monkeypatch):
    make_file, feature = REFUSED[case]
    data = make_file()
    with pytest.raises(jpeg.UnsupportedJPEG, match=feature.replace("(", r"\(").replace(
            ")", r"\)")):
        jpeg.decode(data)
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError) as e:
        png.load_image(str(path), "RGB")
    assert str(path) in str(e.value) and feature in str(e.value)
    assert "PIL is not installed" in str(e.value)


def test_refused_files_go_to_pil():
    """With PIL present the refused files are PIL's: a CMYK file converts
    as PIL converts it, the smoothed progressive file as libjpeg smooths it."""
    for data in (_cmyk(), _without_last_scan(_file("noise", (40, 48), "progressive"))):
        for mode in ("RGB", "L"):
            np.testing.assert_array_equal(png.load_image(data, mode), _pil(data, mode))


def test_decoding_a_jpeg_needs_no_pil(monkeypatch):
    """A JPEG the decoder takes never reaches PIL."""
    data = _file("noise", (37, 53), "progressive")
    want = _pil(data, "RGB")
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(png.load_image(data, "RGB"), want)


# --------------------------------------------------------------------- traps

def float_idct(coef, quant):
    """The textbook IDCT in float64, rounded: the choice libjpeg's islow is
    not."""
    u = np.arange(8)
    c = np.where(u == 0, 1 / np.sqrt(2), 1.0)
    m = (c[:, None] / 2) * np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    f = np.einsum("vy,nvu,ux->nyx", m, (coef * quant).reshape(-1, 8, 8).astype(np.float64), m)
    return np.clip(np.rint(f) + 128, 0, 255).astype(np.uint8).reshape(coef.shape[:-1] + (8, 8))


def float_ycc(y, cb, cr):
    y, cb, cr = (a.astype(np.float64) for a in (y, cb, cr))
    rgb = [y + 1.402 * (cr - 128), y - 0.344136 * (cb - 128) - 0.714136 * (cr - 128),
           y + 1.772 * (cb - 128)]
    return np.clip(np.rint(np.stack(rgb, -1)), 0, 255).astype(np.uint8)


TRAPS = {
    "plain_upsampling": ("upsample", functools.partial(jpeg.upsample, fancy=False)),
    "float_idct": ("idct_islow", float_idct),
    "float_colour": ("ycc_to_rgb", float_ycc),
}


@pytest.mark.parametrize("trap", sorted(TRAPS))
def test_other_choices_fall_outside_bit_equality(trap, monkeypatch):
    data = _file("smooth", (129, 65), "q95_ss2", seed=5)
    want = _pil(data, "RGB")
    np.testing.assert_array_equal(jpeg.decode(data), want)
    monkeypatch.setattr(jpeg, *TRAPS[trap])
    got = jpeg.decode(data)
    assert got.shape == want.shape
    assert (got != want).any()


# ------------------------------------------------------------------ fixtures

with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)


@pytest.mark.parametrize("name", sorted(k for k in DIGESTS if not k.startswith("_")))
def test_fixture_decodes_to_its_digest(name):
    path = os.path.join(FIXTURES, name)
    for mode, want in DIGESTS[name].items():
        pil = np.asarray(Image.open(path).convert(mode))
        assert (digest(pil), list(pil.shape)) == (want["sha256"], want["shape"])
        got = jpeg.load(path, mode)
        assert (digest(got), list(got.shape)) == (want["sha256"], want["shape"])


# ------------------------------------------------------------------- dataset

def _subject_folder(folder):
    folder.mkdir()
    files = {"0.jpg": ("smooth", (70, 90), "q95_ss2"), "1.jpg": ("noise", (64, 64), "progressive"),
             "2.jpeg": ("smooth", (50, 50), "grey"), "3.jpg": ("smooth", (80, 60), "keep_rgb")}
    for i, (name, (content, hw, option)) in enumerate(sorted(files.items())):
        (folder / name).write_bytes(_file(content, hw, option, seed=20 + i))
    mask = (make("smooth", 70, 90, True, 9) > 128).astype(np.uint8) * 255
    png.write(str(folder / "0_mask.png"), mask)
    return folder


def test_dataset_items_equal_jax(tmp_path, monkeypatch):
    from adaface_tpu.data.personalized import PersonalizedDataset as JDataset
    from adaface_tpu.data.personalized import SubjectSpec as JSpec

    from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec

    folder = str(_subject_folder(tmp_path / "subj"))
    draws = [0, 1, 2, 3, (0, True), (0, True), 1]
    jd = JDataset([JSpec("s", folder)], size=48, seed=4)
    want = [jd[i] for i in draws]
    monkeypatch.setitem(sys.modules, "PIL", None)
    td = PersonalizedDataset([SubjectSpec("s", folder)], size=48, seed=4)
    got = [td[i] for i in draws]
    assert len(td.records) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
            else:
                assert g[k] == w[k], k


def test_dataset_keeps_decoded_images_until_the_file_changes(tmp_path, monkeypatch):
    from adaface_tpu_torch.data import personalized
    from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec

    folder = _subject_folder(tmp_path / "subj")
    ds = PersonalizedDataset([SubjectSpec("s", str(folder))], size=32, seed=0)
    calls = []
    real = personalized.load_image
    monkeypatch.setattr(personalized, "load_image", lambda p, m: calls.append(p) or real(p, m))
    rec = ds.records[0]
    first, mask, _ = ds._load(rec)
    again, mask_again, _ = ds._load(rec)
    assert again is first and mask_again is mask and len(calls) == 2
    assert not first.flags.writeable
    np.testing.assert_array_equal(first, _pil((folder / "0.jpg").read_bytes(), "RGB"))
    # a new file at the same path: decoded again
    new = _file("noise", (70, 90), "q75_ss2", seed=99)
    (folder / "0.jpg").write_bytes(new)
    st = os.stat(folder / "0.jpg")
    os.utime(folder / "0.jpg", ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    fresh, _, _ = ds._load(rec)
    assert len(calls) == 3
    np.testing.assert_array_equal(fresh, _pil(new, "RGB"))
