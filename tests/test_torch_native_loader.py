"""The port's copy of the native C++ loader (`data/native_loader.py`,
`native/adaface_loader.cpp` under the port) on the CPU: it builds with g++
into `adaface_tpu_torch/_build/` (skipped where g++, libjpeg or libpng are
missing, as the JAX test skips), and with no augmentation its decode equals
the port's Python load (PNG: bit for bit) and JAX's loader on the same
files; `native_stream` serves batches of the Python path's keys, shapes and
dtypes, and falls back to the Python path when the loader is unavailable."""

import numpy as np
import pytest

from adaface_tpu.data import native_loader as jnative

from adaface_tpu_torch.data import native_loader, png
from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec, _nearest_resize


@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    for i in range(3):
        png.write(str(d / f"{i}.png"), rng.integers(0, 256, (40 + 8 * i, 36, 3), dtype=np.uint8))
    m = np.zeros((40, 36), np.uint8)
    m[8:30, 6:28] = 255
    png.write(str(d / "0_mask.png"), m)
    return str(d)


def _need_loader():
    if not native_loader.is_available():
        pytest.skip(f"native toolchain unavailable: {native_loader.build_error()}")


def test_decode_equals_the_python_load(subject):
    _need_loader()
    ds = PersonalizedDataset([SubjectSpec("s", subject)], size=32, seed=0)
    paths = [r.path for r in ds.records]
    masks = [r.mask_path for r in ds.records]
    loader = native_loader.NativeImageLoader(paths, masks, size=32, flip_p=0.0,
                                             scale_range=None, seed=0, n_workers=1,
                                             queue_capacity=2)
    seen = set()
    try:
        for _ in range(6):
            idx, img, fg, aug = loader.next()
            seen.add(idx)
            image, mask, _ = ds._load(ds.records[idx])
            np.testing.assert_array_equal(img, _nearest_resize(image, 32))
            np.testing.assert_array_equal(fg, (_nearest_resize(mask, 32) / 255).astype(np.uint8))
            assert np.all(aug == 1)
    finally:
        loader.close()
    assert seen == {0, 1, 2}
    if jnative.is_available():
        j = jnative.NativeImageLoader(paths, masks, size=32, flip_p=0.0, scale_range=None,
                                      seed=0, n_workers=1, queue_capacity=2)
        t = native_loader.NativeImageLoader(paths, masks, size=32, flip_p=0.0,
                                            scale_range=None, seed=0, n_workers=1,
                                            queue_capacity=2)
        try:
            for _ in range(3):
                for a, b in zip(t.next(), j.next()):
                    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        finally:
            j.close()
            t.close()


def test_native_stream_serves_the_python_batches_shapes(subject):
    _need_loader()
    ds = PersonalizedDataset([SubjectSpec("s", subject)], size=32, seed=0)
    ref = ds[0]
    stream = ds.native_stream(batch_size=2, n_workers=2, queue_capacity=4)
    try:
        for _ in range(8):
            b = next(stream)
            for k, v in ref.items():
                if isinstance(v, np.ndarray):
                    assert b[k].shape == (2,) + v.shape and b[k].dtype == v.dtype, k
                else:
                    assert len(b[k]) == 2, k
            assert set(np.unique(b["fg_mask"])) <= {0, 1}
    finally:
        stream.close()


def test_native_stream_falls_back_to_python(subject, monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    ds = PersonalizedDataset([SubjectSpec("s", subject)], size=32, seed=5)
    ref = PersonalizedDataset([SubjectSpec("s", subject)], size=32, seed=5)
    stream = ds.native_stream(batch_size=2)
    for _ in range(3):
        b = next(stream)
        want = [ref[int(i)] for i in ref.rng.integers(0, len(ref.records), 2)]
        for i, e in enumerate(want):
            np.testing.assert_array_equal(b["image"][i], e["image"])
            assert b["caption"][i] == e["caption"]
