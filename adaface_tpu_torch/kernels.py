"""Build and load the port's hand-written CUDA kernel libraries.

Each `csrc/<name>.cu` compiles with plain `nvcc` for `sm_90a` into a shared
library with a C interface, loaded with `ctypes`. Libraries go to
`adaface_tpu_torch/_build/`, named by a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags, so a fresh checkout builds at first use
and an edited source or header rebuilds. `build_all` starts one nvcc per
source at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
# C entry name -> its ctypes function, signature set (`entry`)
entries: Dict[str, object] = {}


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump), on PATH or in
    /usr/local/cuda/bin; raises if neither has it."""
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """(output path, temp path, running nvcc) for `name`, or None when the
    library is built already."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen([cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"kernel build failed: nvcc exited {proc.returncode} "
                           f"for {name}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless it is built already. Returns the
    compiler log (register and shared-memory use per kernel), or "" when the
    library was already there; raises if nvcc fails."""
    return _finish(name, _start(name))


def build_all() -> Dict[str, str]:
    """Compile every source, one nvcc each, all started together; waits for
    all of them and returns name -> compiler log."""
    jobs = {p.stem: _start(p.stem) for p in sorted(CSRC.glob("*.cu"))}
    try:
        return {name: _finish(name, job) for name, job in jobs.items()}
    finally:
        for job in jobs.values():
            if job is not None and job[2].poll() is None:
                job[2].kill()
                job[2].wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def entry(name: str, lib: str, argtypes: list):
    """The C entry `name` of `csrc/<lib>.cu` (built first if missing) with
    its argument types set and an int (cudaError_t) result; loaded once,
    then taken from `entries`."""
    fn = entries.get(name)
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entries[name] = fn
    return fn
