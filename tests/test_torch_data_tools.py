"""`tools/exam_wds.py` and `tools/text_sim_exp.py` against the JAX package's
scripts on the CPU:

- exam_wds on a seeded shard: the same lines and pass rate; `--dump` writes
  PNGs (JAX writes JPEGs) equal bit for bit to JAX's compositor's images;
- text_sim_exp with the same HF-format CLIP file (`CLIP_SCORER_PT`) in both
  packages: `triplet_cosines` within 1e-5 of JAX's arithmetic on its own
  scorer (the script's sentence and token-mean arms), and the printed lines
  equal up to their 3 decimals."""

import importlib.util
import io
import json
import os
import re
import tarfile

import numpy as np
import pytest

import jax.numpy as jnp

from adaface_tpu.data import wds as jwds
from adaface_tpu.evaluation import scorers as jsc

from adaface_tpu_torch.data import png
from adaface_tpu_torch.evaluation import scorers as tsc
from adaface_tpu_torch.tools import exam_wds, text_sim_exp

from test_torch_evaluation import _hf_files, _patch_tiny_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}_script",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _add(tf, name, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_shard(path, seed=0):
    """A PNG-only shard: accepted backgrounds, and captions and sizes that
    the compositor's filters reject."""
    rng = np.random.default_rng(seed)
    rows = [("a sunny mountain landscape with trees", (64, 64), (640, 640)),
            ("a man walking on the beach", (64, 64), (640, 640)),
            ("a quiet forest clearing at dawn", (64, 64), (64, 64)),
            ("old red barn under a grey sky", (48, 64), (800, 600)),
            ("the letter z carved into stone", (64, 64), (640, 640)),
            ("a lake at dusk", (70, 64), (640, 700)),
            ("a wide panorama of dunes", (32, 64), (1280, 640))]
    with tarfile.open(path, "w") as tf:
        for i, (caption, (h, w), (ow, oh)) in enumerate(rows):
            _add(tf, f"{i:03}.png", png.encode(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
            _add(tf, f"{i:03}.json", json.dumps({
                "caption": caption, "width": w, "height": h, "original_width": ow,
                "original_height": oh}).encode())
    return str(path)


def test_exam_wds_equals_jax(tmp_path, capsys):
    shard = write_shard(tmp_path / "shard-000.tar")
    jdump, tdump = tmp_path / "jax", tmp_path / "port"
    argv = [shard, "--n", "6", "--size", "32"]
    assert _script("exam_wds").main(argv + ["--dump", str(jdump)]) == 0
    jout = capsys.readouterr().out
    assert exam_wds.main(argv + ["--dump", str(tdump)]) == 0
    tout = capsys.readouterr().out
    assert tout == jout
    assert re.search(r"^\d/6 accepted$", tout, re.M)
    names = sorted(os.listdir(tdump))
    assert names == [n.replace(".jpg", ".png") for n in sorted(os.listdir(jdump))]
    comp = jwds.BackgroundCompositor([shard], size=32)
    for name in names:
        img, _ = comp.next_background()
        assert np.array_equal(png.read(str(tdump / name)), np.asarray(img)), name


def _jax_cosines(clip, triplets):
    """The JAX script's arithmetic, on its own scorer."""
    out = []
    for words in triplets:
        ids = jnp.asarray(clip.tokenizer(list(words)))
        seq = clip.text.apply({"params": clip.text_params}, ids)
        feats = seq.mean(axis=1)
        tok = np.asarray(feats / jnp.linalg.norm(feats, axis=-1, keepdims=True))
        sent = np.asarray(clip.get_text_features(list(words)))
        row = {}
        for arm, (fa, fb, fc) in (("sentence", sent), ("token_mean", tok)):
            fbc = fb + fc
            fbc = fbc / np.linalg.norm(fbc)
            row[arm] = (float(fa @ fb), float(fa @ fc), float(fa @ fbc))
        out.append(row)
    return out


def test_text_sim_exp_equals_jax(tmp_path, monkeypatch, capsys):
    clip_path, dino_path = _hf_files(tmp_path)
    _patch_tiny_configs(monkeypatch)
    monkeypatch.setenv("CLIP_SCORER_PT", clip_path)
    monkeypatch.setenv("DINO_VITS16_PT", dino_path)
    for k in ("CLIP_VOCAB_JSON", "CLIP_MERGES_TXT"):
        monkeypatch.delenv(k, raising=False)
    extra = ["a red car", "a blue car", "a tree"]
    with pytest.warns(UserWarning, match="HashTokenizer"):
        assert _script("text_sim_exp").main(["--triplet", *extra]) == 0
    jout = capsys.readouterr().out
    with pytest.warns(UserWarning, match="HashTokenizer"):
        assert text_sim_exp.main(["--triplet", *extra], device="cpu") == 0
    tout = capsys.readouterr().out
    num = re.compile(r"-?\d+\.\d{3}")
    assert num.sub("#", tout) == num.sub("#", jout)
    for a, b in zip(num.findall(tout), num.findall(jout)):
        assert float(a) == pytest.approx(float(b), abs=1.5e-3)
    triplets = text_sim_exp.TRIPLETS[:2] + [extra]
    with pytest.warns(UserWarning):
        jclip, _ = jsc.init_evaluators()
    with pytest.warns(UserWarning):
        tclip, _ = tsc.init_evaluators(device="cpu")
    got = text_sim_exp.triplet_cosines(tclip, triplets)
    want = _jax_cosines(jclip, triplets)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for arm in ("sentence", "token_mean"):
            np.testing.assert_allclose(g[arm], w[arm], rtol=0, atol=1e-5)
