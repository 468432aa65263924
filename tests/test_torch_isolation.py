"""The port stands alone: importing `adaface_tpu_torch` loads neither JAX,
flax nor the JAX package (checked in a fresh interpreter, since this test
process has JAX loaded by conftest), and no source file of the port or
`chip_smoke.py` imports them. The card's machine has no pyyaml and no PIL:
the training entry point, its config loader and the trainer load neither,
and no source of the port imports yaml."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import adaface_tpu_torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "adaface_tpu")
IMPORT_RE = re.compile(
    r"^\s*(?:from\s+(?:jax|jaxlib|flax|adaface_tpu)(?:\.|\s)"
    r"|import\s+(?:jax|jaxlib|flax|adaface_tpu)(?:\.|\s|,|$))", re.MULTILINE)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        adaface_tpu_torch.__path__, "adaface_tpu_torch."))


def test_import_loads_no_jax():
    mods = _port_modules()
    for m in ("pipeline", "training.trainer", "training.train_step", "training.losses",
              "training.prodigy", "data.personalized", "ops.grad", "models.clip_vision",
              "personalization.arc2face", "personalization.subj_basis_generator",
              "personalization.zero_shot"):
        assert f"adaface_tpu_torch.{m}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    # exact top-level names: adaface_tpu_torch itself starts with "adaface_tpu"
    assert "LOADED []" in r.stdout, r.stdout


def test_sources_import_no_jax():
    files = sorted((REPO / "adaface_tpu_torch").rglob("*.py")) + [
        REPO / name for name in ("chip_smoke.py", "flash_variants.py", "ff_variants.py",
                                 "wino_variants.py", "gn_variants.py", "kernel_variants.py")]
    assert len(files) > 10
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in IMPORT_RE.finditer(f.read_text())]
    assert hits == []


def test_scan_pattern_catches_forbidden_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from flax import linen",
                 "from adaface_tpu.ops import basic", "import adaface_tpu"):
        assert IMPORT_RE.search(line), line
    for line in ("import adaface_tpu_torch", "from adaface_tpu_torch.ops import basic",
                 "import jaxtyping_not_jax_module_name_x"):
        assert not IMPORT_RE.search(line), line


YAML_RE = re.compile(r"^\s*(?:from\s+yaml(?:\.|\s)|import\s+yaml(?:\.|\s|,|$))", re.MULTILINE)


def test_entry_point_loads_no_yaml_or_pil():
    code = ("import importlib, sys\n"
            "for m in ('adaface_tpu_torch.train', 'adaface_tpu_torch.config',\n"
            "          'adaface_tpu_torch.training.trainer'):\n"
            "    importlib.import_module(m)\n"
            "print('LOADED', sorted(m for m in sys.modules\n"
            "                       if m.split('.')[0] in ('yaml', 'PIL')))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_sources_import_no_yaml():
    files = sorted((REPO / "adaface_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "ab_paths.py"]
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in YAML_RE.finditer(f.read_text())]
    assert hits == []
    for line in ("import yaml", "from yaml import safe_load", "  import yaml as y"):
        assert YAML_RE.search(line), line
    assert not YAML_RE.search("from adaface_tpu_torch import _yaml")
