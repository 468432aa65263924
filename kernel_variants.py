"""Build text-patched variants of the port's kernel sources side by side.

The `*_variants.py` timing scripts and the planted faults of `chip_smoke.py`
use it. A variant is (source directory, source file, patches): the source,
as `kernel.cu`, and the directory's shared headers (`*.cuh`), with each
patch (old, new) an exact text substitution in the first of those files
that holds `old` (the source first). Each variant is written to
`_variants/<prefix><name>/` (git-ignored) and built by its own nvcc with the
port's flags (`kernels.NVCC_FLAGS`), all started together.
"""

import ctypes
import os
import subprocess

from adaface_tpu_torch import kernels

CSRC = "adaface_tpu_torch/csrc"
OLD_CSRC = "_checkout/" + CSRC  # an older tree: `git archive <commit> | tar -x -C _checkout`
OUT = "_variants"


def patched_sources(src_dir, source, patches):
    """File name -> text of one variant: `kernel.cu` (the source) and the
    headers of `src_dir`, patched. Raises ValueError if the source is
    missing or a patch applies nowhere."""
    if not os.path.exists(f"{src_dir}/{source}"):
        raise ValueError(f"no {src_dir}/{source}")
    files = {"kernel.cu": open(f"{src_dir}/{source}").read()}
    for f in sorted(os.listdir(src_dir)):
        if f.endswith(".cuh"):
            files[f] = open(f"{src_dir}/{f}").read()
    for old, new in patches:
        where = [f for f, text in files.items() if old in text]
        if not where:
            raise ValueError(f"a patch does not apply ({old!r})")
        files[where[0]] = files[where[0]].replace(old, new)
    return files


def ptxas_lines(log):
    """The register and non-zero spill lines of an nvcc log, each after the
    entry it belongs to (its mangled name's tail)."""
    entry, lines = "", []
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("_Z")[-1].split("EEEv")[0][-24:]
        elif "registers" in line or ("spill" in line and "0 bytes spill" not in line):
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return lines


def start(variants, prefix=""):
    """variants: name -> (source directory, source file, patches). Writes
    each variant and starts its nvcc; returns the pending build, for
    `finish` (or `stop`). Raises ValueError, naming the variant, if a patch
    does not apply; no nvcc is left running then."""
    procs = {}
    try:
        for name, (src_dir, source, patches) in variants.items():
            try:
                files = patched_sources(src_dir, source, patches)
            except ValueError as e:
                raise ValueError(f"variant {name}: {e}") from e
            d = f"{OUT}/{prefix}{name}"
            os.makedirs(d, exist_ok=True)
            for f, text in files.items():
                with open(f"{d}/{f}", "w") as fh:
                    fh.write(text)
            procs[name] = subprocess.Popen(
                [kernels.cuda_tool("nvcc"), *kernels.NVCC_FLAGS, "-o", f"{d}/lib.so",
                 f"{d}/kernel.cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except BaseException:
        stop((prefix, procs))
        raise
    return prefix, procs


def stop(pending):
    """Kill the nvcc of a pending build that still run."""
    for proc in pending[1].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish(pending):
    """Wait for a pending build; returns name -> (the loaded library, nvcc's
    log). Raises RuntimeError, naming the variant, if nvcc fails; no nvcc
    outlives it."""
    prefix, procs = pending
    try:
        logs = {name: proc.communicate()[0] for name, proc in procs.items()}
    finally:
        stop(pending)
    for name, proc in procs.items():
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc exited {proc.returncode}\n"
                               f"{logs[name][-3000:]}")
    return {name: (ctypes.CDLL(os.path.abspath(f"{OUT}/{prefix}{name}/lib.so")), logs[name])
            for name in procs}


def build(variants, prefix=""):
    """`start` then `finish`: one nvcc per variant, all started together."""
    return finish(start(variants, prefix))
