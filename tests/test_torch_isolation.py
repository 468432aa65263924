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


def test_face_tools_load_no_pil(tmp_path):
    """The face tools and the new models import without PIL, and a tools
    run on PNGs loads none: `gen_face_masks --precise` on images at
    `--parsing_size` (the resizes are copies) and `--use_detector
    --detector retinaface` (an integer-index resize)."""
    import numpy as np
    import torch

    from adaface_tpu_torch.data import png

    from test_bisenet import synth_state_dict

    mods = [m for m in _port_modules() if m.startswith("adaface_tpu_torch.tools.")]
    assert {f"adaface_tpu_torch.tools.{t}" for t in
            ("gen_face_masks", "filter_faces", "knn_faces", "comparefaces")} <= set(mods)
    mods += [f"adaface_tpu_torch.{m}" for m in ("models.scrfd", "models.retinaface",
                                                "models.bisenet", "interop.bisenet")]
    folder = tmp_path / "faces"
    folder.mkdir()
    g = np.random.default_rng(0)
    for i in range(2):
        png.write(str(folder / f"{i}.png"), g.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    ckpt = str(tmp_path / "79999_iter.pth")
    torch.save({k: torch.tensor(v) for k, v in synth_state_dict(0).items()}, ckpt)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print('IMPORTED', sorted(m for m in sys.modules if m.split('.')[0] == 'PIL'))\n"
            "from adaface_tpu_torch.tools import gen_face_masks as g\n"
            f"g.main([{str(folder)!r}, '--precise', '--parsing_ckpt', {ckpt!r},\n"
            "        '--parsing_size', '64'], device='cpu')\n"
            f"g.main([{str(folder)!r}, '--use_detector', '--detector', 'retinaface',\n"
            "        '--overwrite'], device='cpu')\n"
            "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0] == 'PIL'))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env.pop("RETINAFACE_PT", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "IMPORTED []" in r.stdout and "LOADED []" in r.stdout, r.stdout
    assert "wrote 2 masks (trash 0, inspect 0)" in r.stdout, r.stdout


NEW_ENTRY_POINTS = ("app", "gen_subjects_and_eval", "evaluate_subjects", "webui_params",
                    "utils", "data.resample", "tools.zero_shot_test", "tools.gen_db_reg",
                    "tools.export_embeddings", "tools.merge_embeddings", "tools.avgemb",
                    "tools.chk_ckpt_weights", "tools.modeldiff", "tools.repl_component",
                    "tools.resize_imgs", "tools.exam_wds", "tools.text_sim_exp")


def test_cli_entry_points_load_no_yaml_or_pil(tmp_path):
    """The evaluation and serving CLIs and the checkpoint, embedding and data
    tools import without yaml and PIL, and their host paths run on PNGs with
    neither loaded: the settings round trip, `resize_imgs`, a resize through
    `txt2img.load_resized` and `gen_face_masks.pil_resize`, `exam_wds
    --dump`."""
    import numpy as np

    from adaface_tpu_torch.data import png

    from test_torch_data_tools import write_shard

    mods = _port_modules()
    for m in NEW_ENTRY_POINTS:
        assert f"adaface_tpu_torch.{m}" in mods, m
    src = tmp_path / "src"
    src.mkdir()
    g = np.random.default_rng(0)
    png.write(str(src / "a.png"), g.integers(0, 256, (60, 90, 3), dtype=np.uint8))
    shard = write_shard(tmp_path / "shard.tar")
    code = ("import importlib, sys\n"
            f"for m in {NEW_ENTRY_POINTS!r}: importlib.import_module('adaface_tpu_torch.' + m)\n"
            "print('IMPORTED', sorted(m for m in sys.modules\n"
            "                         if m.split('.')[0] in ('yaml', 'PIL')))\n"
            "from adaface_tpu_torch import webui_params as w, txt2img\n"
            "from adaface_tpu_torch.tools import resize_imgs, exam_wds, gen_face_masks\n"
            f"w.update_settings({str(tmp_path / 's.yaml')!r}, seed=3, prompt='a ' * 60)\n"
            f"assert w.load_settings({str(tmp_path / 's.yaml')!r})[0].seed == 3\n"
            f"resize_imgs.main([{str(src)!r}, {str(tmp_path / 'dst')!r}, '--size', '32'])\n"
            f"assert txt2img.load_resized({str(src / 'a.png')!r}, 40).shape == (40, 40, 3)\n"
            f"img = txt2img.load_resized({str(src / 'a.png')!r}, 40)\n"
            "assert gen_face_masks.pil_resize(img, (20, 30), 'bilinear').shape == (30, 20, 3)\n"
            f"exam_wds.main([{shard!r}, '--n', '3', '--size', '32', '--dump',\n"
            f"               {str(tmp_path / 'dump')!r}])\n"
            "print('LOADED', sorted(m for m in sys.modules\n"
            "                       if m.split('.')[0] in ('yaml', 'PIL')))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "tests"), env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "IMPORTED []" in r.stdout and "LOADED []" in r.stdout, r.stdout
    assert "resized 1 images" in r.stdout
