"""ctypes bridge to the port's copy of the native C++ prefetching image
loader (`adaface_tpu_torch/native/adaface_loader.cpp`).

The source builds with `g++` at first use into `adaface_tpu_torch/_build/`,
named by a hash of the source and the command, so an edited source
rebuilds. `NativeImageLoader` is a threaded decode + augment prefetcher with
`PersonalizedDataset`'s image-side semantics (NEAREST resample, flip, center
scale, margin shift). It is a host-side data loader, not a device kernel:
`is_available()` is False when the toolchain or libjpeg / libpng are
absent, and callers keep the Python path (`build_error()` says why).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "adaface_loader.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lz", "-pthread")

_lib = None
_build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libadaface_loader-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile the loader into `out`; the compiler's message on failure."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS],
                       check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        return e.stderr or str(e)
    except FileNotFoundError as e:
        return str(e)
    os.replace(tmp, out)
    return None


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    out = library_path()
    if not out.exists():
        _build_error = _build(out)
        if _build_error:
            return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:  # built elsewhere, its image libraries missing here
        _build_error = str(e)
        return None
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint8)] * 3
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


class NativeImageLoader:
    """Threaded prefetching loader over (image path, mask path) records."""

    def __init__(self, paths: Sequence[str], mask_paths: Sequence[Optional[str]],
                 size: int = 512, flip_p: float = 0.5, scale_range=(0.7, 1.0),
                 seed: int = 0, n_workers: int = 2, queue_capacity: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self._h = None
        self.size = size
        self.paths: List[str] = list(paths)
        n = len(self.paths)
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in self.paths])
        c_masks = (ctypes.c_char_p * n)(*[(m.encode() if m else None) for m in mask_paths])
        lo, hi = scale_range if scale_range else (0.0, 0.0)
        self._h = lib.loader_create(c_paths, c_masks, n, size, flip_p, lo, hi, seed,
                                    n_workers, queue_capacity)
        self._img = np.empty((size, size, 3), np.uint8)
        self._fg = np.empty((size, size), np.uint8)
        self._aug = np.empty((size, size), np.uint8)

    def next(self):
        """(record index, image u8 [S, S, 3], fg_mask u8 [S, S], aug_mask u8
        [S, S]); undecodable records are skipped."""
        ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            idx = self._lib.loader_next(self._h, ptr(self._img), ptr(self._fg), ptr(self._aug))
            if idx == -1:
                continue  # a decode failure: draw again
            if idx == -2:
                raise StopIteration
            return idx, self._img.copy(), self._fg.copy(), self._aug.copy()

    def close(self):
        if self._h:
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
