"""The port's training entry point, `python -m adaface_tpu_torch.train`,
against `scripts/train.py`'s per-subject path, on the CPU (tiny models,
PNGs written with PIL into a temporary folder).

- Resolution: for each shipped per-subject config, with and without
  explicit flags and dotlist overrides (the JAX script's quirks among
  them), the `TrainerConfig` and `IterPlanConfig` that each script hands
  its `Trainer` are equal field by field (both trainers are replaced by
  recorders), and so are the pipeline's dtype, the UNet's `use_remat`, the
  clip-skip weights and the placeholders. The port's configs have every
  field of JAX's (`JAX_ONLY_FIELDS` is empty).
- Init words: from the same CLIP weights (through `interop/from_jax.py`),
  `word_init` gives the same `pre_vecs` and common weights as JAX's,
  `--subj_init_word_weights` included; the rank check exits.
- End to end: `main([... --tiny --max_steps 4 --base <config>],
  device="cpu")` trains; JAX's `load_native` reads its
  `embeddings_last.npz`; a run resumed from the state saved at step 2
  (`--resume`) ends with the same embeddings as the uninterrupted run, bit
  for bit.
- Each path that is not ported exits with `SystemExit` naming its ROADMAP
  item."""

import copy
import dataclasses
import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

import adaface_tpu.training.trainer as jtrainer_mod
from adaface_tpu.personalization.embedding_manager import EmbeddingManager as JEM

import adaface_tpu_torch.train as ttrain
from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = {name: os.path.join(ROOT, "configs", f"{name}.yaml")
           for name in ("finetune-static-layerwise", "finetune-ti", "finetune-ada")}
JAX_ONLY_FIELDS = {"TrainerConfig": set(), "IterPlanConfig": set()}


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_script",
                                                  os.path.join(ROOT, "scripts", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("subject")
    for i in range(3):
        img = np.random.default_rng(i).integers(0, 256, (80, 72, 3), dtype=np.uint8)
        Image.fromarray(img).save(d / f"{i}.png")
    return str(d)


class _Stop(Exception):
    pass


def _recorder(store):
    class Recorder:
        def __init__(self, pipe, dataset, cfg, plan_cfg):
            store.update(pipe=pipe, cfg=cfg, plan_cfg=plan_cfg)
            raise _Stop
    return Recorder


_JAX_PIPES = {}


def _cached_jax_pipeline(real):
    """JAX's `from_random`, built once per dtype (its tiny init compiles for
    seconds) and handed out as a copy with a fresh tokenizer and embedding
    manager; the script rebuilds the UNet module on its copy only."""
    def from_random(key, tokenizer, dtype=jax.numpy.float32, **kw):
        k = (str(dtype), repr(sorted(kw.items())))
        if k not in _JAX_PIPES:
            _JAX_PIPES[k] = real(key, tokenizer, dtype=dtype, **kw)
        pipe = copy.copy(_JAX_PIPES[k])
        pipe.tokenizer, pipe.embedding_manager = tokenizer, JEM()
        return pipe
    return from_random


def _resolve(monkeypatch, jax_script, argv):
    """(JAX's, the port's) recorded Trainer arguments for one command line."""
    from adaface_tpu.pipeline import StableDiffusionPipeline as JPipeline

    got_j, got_t = {}, {}
    with monkeypatch.context() as m:
        m.setattr(JPipeline, "from_random", _cached_jax_pipeline(JPipeline.from_random))
        m.setattr(jtrainer_mod, "Trainer", _recorder(got_j))
        m.setattr(sys, "argv", ["train.py"] + argv)  # JAX reads its explicit flags here
        with pytest.raises(_Stop):
            jax_script.main(jax_script.parse_args(argv))
    with monkeypatch.context() as m:
        m.setattr(ttrain, "Trainer", _recorder(got_t))
        with pytest.raises(_Stop):
            ttrain.main(argv, device="cpu")
    return got_j, got_t


CASES = {
    "as shipped": [],
    "explicit flags": ["--max_steps", "9", "--batch_size", "2", "--accumulate_grad_batches",
                       "3", "--ckpt_every_steps", "4", "--composition_regs_iter_gap", "2",
                       "--seed", "5", "--num_vectors_per_subj_token", "3",
                       "--clip_last_layers_skip_weights", "1", "3"],
    # --optimizer prodigy loses to the file's use_prodigy; --lr at its default
    # value loses to the file's learning_rate; -l is not "explicit"; dotlist
    # values pass through as YAML 1.1 gives them ('1e-1' stays a string)
    "quirks": ["--optimizer", "prodigy", "--lr", "7e-4", "-l", "LOGDIR",
               "trainer.grad_clip=1e-1", "trainer.learning_rate=1e-4",
               "iter_plan.mix_prompt_distill_weight=3.0e-4", "data.p_wds_comp_recon=0.1"],
    "adamw bf16 remat": ["--optimizer", "adamw", "--lr", "1e-3", "--bf16",
                         "--background_string", "", "model_options.use_remat=true",
                         "trainer.use_ema=true", "trainer.ema_decay=0.99",
                         "trainer.scale_lr=false"],
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_resolved_configs_equal_jax(monkeypatch, jax_script, data_root, tmp_path, config,
                                    case):
    argv = ["--base", CONFIGS[config], "--data_root", data_root, "--tiny", "--size", "64",
            "--logdir", str(tmp_path / "log")]
    argv += [str(tmp_path / "short") if a == "LOGDIR" else a for a in CASES[case]]
    jg, tg = _resolve(monkeypatch, jax_script, argv)
    for name in ("cfg", "plan_cfg"):
        j, t = dataclasses.asdict(jg[name]), dataclasses.asdict(tg[name])
        cls = type(jg[name]).__name__
        assert set(j) - set(t) == JAX_ONLY_FIELDS[cls]
        assert {k: t[k] for k in j} == j, (name, case)
        for k in j:  # types too: '1e-1' must stay a str, 4.0e-3 a float
            assert type(t[k]) is type(j[k]), (name, k, t[k], j[k])
    jp, tp = jg["pipe"], tg["pipe"]
    assert (tp.unet.in_conv.weight.dtype == torch.bfloat16) == (jp.dtype == jax.numpy.bfloat16)
    assert tp.unet.cfg.use_remat == jp.unet.cfg.use_remat
    assert tuple(tp.skip_weights) == tuple(jp.skip_weights)
    jm, tm = jp.embedding_manager, tp.embedding_manager
    assert ({s: (i.num_vectors, i.is_background) for s, i in tm.placeholders.items()}
            == {s: (i.num_vectors, i.is_background) for s, i in jm.placeholders.items()})


def test_word_init_gives_jax_pre_vecs(monkeypatch, jax_script, data_root, tmp_path):
    """Same CLIP weights in both (the JAX tiny pipeline's, through
    from_jax): the subject's pre_vecs and common weights from two init words
    weighted 1:3, and the background's from "unknown"."""
    argv = ["--base", CONFIGS["finetune-static-layerwise"], "--data_root", data_root,
            "--tiny", "--size", "64", "--cls_delta_string", "young man",
            "--subj_init_word_weights", "1", "3", "--logdir", str(tmp_path)]
    got_j = {}
    with monkeypatch.context() as m:
        m.setattr(jtrainer_mod, "Trainer", _recorder(got_j))
        m.setattr(sys, "argv", ["train.py"] + argv)
        with pytest.raises(_Stop):
            jax_script.main(jax_script.parse_args(argv))
    clip_sd = from_jax.clip_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, got_j["pipe"].clip_params))
    real = ttrain.StableDiffusionPipeline.from_random

    def with_jax_clip(*a, **k):
        pipe = real(*a, **k)
        pipe.clip.load_state_dict(clip_sd, strict=True)
        return pipe

    got_t = {}
    monkeypatch.setattr(ttrain.StableDiffusionPipeline, "from_random", with_jax_clip)
    monkeypatch.setattr(ttrain, "Trainer", _recorder(got_t))
    with pytest.raises(_Stop):
        ttrain.main(argv, device="cpu")
    je, te = got_j["pipe"].embedding_manager.embedders, got_t["pipe"].embedding_manager.embedders
    assert sorted(je) == sorted(te) == ["y", "z"]
    for s in ("z", "y"):
        np.testing.assert_array_equal(te[s].pre_vecs.numpy(), np.asarray(je[s].pre_vecs))
        np.testing.assert_allclose(te[s].basis_comm_weights.numpy(),
                                   np.asarray(je[s].basis_comm_weights), rtol=1e-7)
    assert te["z"].pre_vecs.shape[1] == 2  # "young man": two init tokens
    with pytest.raises(SystemExit, match="rank"):
        ttrain.main(argv + ["--layerwise_lora_rank", "1"], device="cpu")


def _train(argv, tmp_path, name):
    logdir = tmp_path / name
    assert ttrain.main(argv + ["--logdir", str(logdir)], device="cpu") == 0
    return logdir


@pytest.mark.parametrize("config", ["finetune-ti", "finetune-static-layerwise"])
def test_cli_trains_jax_reads_and_resume_is_exact(monkeypatch, data_root, tmp_path, config):
    """4 micro-steps (compos at 0 and 3) with the state kept at step 2; JAX's
    loader reads the checkpoint; a run resumed from the step-2 state ends
    with the same embeddings, bit for bit."""
    real_save = Trainer.save_state

    def keep_each_state(self, path=None):
        path = real_save(self, path)
        shutil.copy(path, os.path.join(self.cfg.logdir, f"state_{self.global_step}.pt"))
        return path

    monkeypatch.setattr(Trainer, "save_state", keep_each_state)
    base = ["--base", CONFIGS[config], "--data_root", data_root, "--tiny", "--size", "64",
            "--max_steps", "4", "--ckpt_every_steps", "2"]
    whole = _train(base, tmp_path, "whole")
    ckpt = str(whole / "embeddings_last.npz")
    jm, tm = JEM.load_native(ckpt), EmbeddingManager.load_native(ckpt)
    assert sorted(jm.embedders) == sorted(tm.embedders)
    for s in tm.embedders:
        np.testing.assert_array_equal(np.asarray(jm.embedders[s].basis_rand_weights),
                                      tm.embedders[s].basis_rand_weights.numpy())
    nvec = {"finetune-ti": 1, "finetune-static-layerwise": 9}[config]
    assert jm.placeholders["z"].num_vectors == nvec
    assert ("y" in jm.placeholders) == (config != "finetune-ti")
    assert os.path.exists(whole / "train_state.pt")

    resumed = _train(base + ["--resume", str(whole / "state_2.pt")], tmp_path, "resumed")
    a = np.load(whole / "embeddings_last.npz")
    b = np.load(resumed / "embeddings_last.npz")
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f])
    first = np.load(whole / "embeddings_gs-2.npz")
    assert any(not np.array_equal(first[f], a[f]) for f in a.files if f != "__header__")


UNPORTED = {
    "zeroshot": (["--zeroshot"], "item 12"),
    # ported: without its text encoder the teacher exits as the JAX script does
    "arc2face": (["--arc2face_unet", "teacher"],
                 "--arc2face_unet requires --arc2face_text_encoder"),
    "dreambooth": (["--dreambooth"], "item 10"),
    "actual_resume": (["--actual_resume", "sd.ckpt"], "item 10b"),
    "pt checkpoint": (["--embedding_manager_ckpt", "emb.pt"], "item 10b"),
    "num_devices": (["--num_devices", "2"], "item 13"),
    "val_every": (["--val_every", "5"], "item 10"),
    "val_every_steps": (["trainer.val_every_steps=5"], "item 10"),
    "wds_shards": (["data.wds_shards=[a.tar]"], "item 10"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_paths_exit(data_root, tmp_path, name):
    extra, item = UNPORTED[name]
    argv = ["--base", CONFIGS["finetune-ada"], "--data_root", data_root, "--tiny",
            "--logdir", str(tmp_path)] + extra
    with pytest.raises(SystemExit, match=item):
        ttrain.main(argv, device="cpu")
