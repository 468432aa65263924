"""The port's entry points of this slice on the CPU, against the JAX scripts:
`python -m adaface_tpu_torch.train --zeroshot` (`scripts/train.py
run_zero_shot`) and `python -m adaface_tpu_torch.txt2img --compare_with
--calc_face_sim` (`scripts/txt2img.py evaluate`).

- Resolution: for `finetune-ada.yaml` under `--tiny`, as shipped and with
  explicit flags (`--bf16`, no bg placeholder, `--seed`), both scripts hand
  their `ZeroShotTrainer` (replaced by recorders) equal `TrainerConfig` and
  `IterPlanConfig` fields (`do_zero_shot` on), the same placeholders, K and
  bg set, generators of the same kind and widths, the same vision tower and
  Arc2Face encoder configs, and a face embedder; the port's towers and
  generators are fp32 whatever `--bf16` says, as JAX's are.
- End to end: `main([--zeroshot --tiny ...], device="cpu")` trains 4
  micro-steps (a compos one among them) and writes `subj_basis_last.pt`,
  which a `ZeroShotTrainer` loads back; a run resumed from its step-2
  checkpoint ends with the uninterrupted run's generators, bit for bit; a
  reference `.pt` holding a generator warm-starts the fg generator with
  the file's weights, bit for bit.
- Scoring: the port's `txt2img --compare_with --calc_face_sim` on seeded
  reference PNGs, with scorer files in both packages' env (the configs
  patched to tiny widths as in `test_torch_evaluation.py`) and JAX's tiny
  recognizer carried over for the face similarity: JAX's `evaluate` on the
  port's output folder gives the same scores within 1e-5, and the same
  `scores.csv` row.
"""

import argparse
import csv
import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adaface_tpu.training.zs_trainer as jzs_mod
from adaface_tpu.models import arcface as ja

import adaface_tpu_torch.train as ttrain
import adaface_tpu_torch.training.zs_trainer as tzs_mod
from adaface_tpu_torch import txt2img as tt2i
from adaface_tpu_torch.data import png
from adaface_tpu_torch.interop.from_jax import iresnet_state_dict_from_jax
from adaface_tpu_torch.models import arcface as ta

from test_torch_cli import CONFIGS, ROOT, _cached_jax_pipeline, _Stop, jax_script  # noqa: F401
from test_torch_evaluation import _hf_files, _patch_tiny_configs

torch.set_num_threads(2)

SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def zs_root(tmp_path_factory):
    """Two subjects of two PNGs each (64x64)."""
    root = tmp_path_factory.mktemp("zs")
    rng = np.random.default_rng(0)
    for s in ("a", "b"):
        (root / s).mkdir()
        for i in range(2):
            png.write(str(root / s / f"{i}.png"), rng.integers(0, 256, (64, 64, 3), np.uint8))
    return str(root)


def _zs_recorder(store, jax_side):
    class Recorder:
        def __init__(self, pipe, dataset, ext, gens, *rest, plan_cfg=None, bg_placeholders=()):
            if jax_side:
                tree, arc, arc_params, cfg = rest[:4]
                store.update(tree=tree, arc_params=arc_params)
            else:
                arc, cfg = rest[:2]
                plan_cfg = plan_cfg if plan_cfg is not None else rest[2]
            store.update(pipe=pipe, ext=ext, gens=gens, arc=arc, cfg=cfg, plan_cfg=plan_cfg,
                         bg=frozenset(bg_placeholders))
            raise _Stop
    return Recorder


def _resolve(monkeypatch, jax_script, argv):
    from adaface_tpu.pipeline import StableDiffusionPipeline as JPipeline

    got_j, got_t = {}, {}
    with monkeypatch.context() as m:
        m.syspath_prepend(os.path.join(ROOT, "scripts"))
        m.setattr(JPipeline, "from_random", _cached_jax_pipeline(JPipeline.from_random))
        m.setattr(jzs_mod, "ZeroShotTrainer", _zs_recorder(got_j, True))
        m.setattr(sys, "argv", ["train.py"] + argv)
        with pytest.raises(_Stop):
            jax_script.main(jax_script.parse_args(argv))
    with monkeypatch.context() as m:
        m.setattr(tzs_mod, "ZeroShotTrainer", _zs_recorder(got_t, False))
        with pytest.raises(_Stop):
            ttrain.main(argv, device="cpu")
    return got_j, got_t


@pytest.mark.parametrize("extra", [[], ["--bf16", "--background_string", "", "--seed", "3"]])
def test_zeroshot_resolves_like_jax(monkeypatch, jax_script, zs_root, tmp_path, extra):
    argv = ["--zeroshot", "--base", CONFIGS["finetune-ada"], "--data_root", zs_root,
            "--subjects", "a", "b", "--tiny", "--size", "32", "--logdir", str(tmp_path)] + extra
    jg, tg = _resolve(monkeypatch, jax_script, argv)
    for name in ("cfg", "plan_cfg"):
        j, t = dataclasses.asdict(jg[name]), dataclasses.asdict(tg[name])
        assert {k: t[k] for k in j} == j, name
    assert tg["plan_cfg"].do_zero_shot and jg["bg"] == tg["bg"]
    jm, tm = jg["pipe"].embedding_manager, tg["pipe"].embedding_manager
    assert ({s: (i.num_vectors, i.is_background) for s, i in tm.placeholders.items()}
            == {s: (i.num_vectors, i.is_background) for s, i in jm.placeholders.items()})
    assert sorted(tg["gens"]) == sorted(jg["gens"]) == sorted(tm.subj_basis_generators)
    for s, g in tg["gens"].items():
        j = jg["gens"][s]
        assert (g.placeholder_is_bg, g.num_out_embs_per_layer, g.output_dim) == \
            (j.placeholder_is_bg, j.num_out_embs_per_layer, j.output_dim)
        if g.placeholder_is_bg:
            assert g.bg_proj_dense.in_features == j.image_embedding_dim
            assert g.pos_embs.shape[1] == j.bg_num_id_vecs
        else:
            assert dataclasses.asdict(g.prompt2token_proj.cfg) == \
                {k: v for k, v in dataclasses.asdict(j.proj_cfg).items()}
        assert all(p.dtype == torch.float32 for p in g.parameters())
    assert dataclasses.asdict(tg["ext"].vision.cfg) == dataclasses.asdict(jg["ext"].vision.cfg)
    assert dataclasses.asdict(tg["arc"].cfg) == dataclasses.asdict(jg["arc"].cfg)
    for m in (tg["ext"].vision, tg["arc"]):
        assert all(p.dtype == torch.float32 for p in m.parameters())
    assert tg["pipe"].unet.in_conv.weight.dtype == torch.bfloat16  # the file's dtype
    img = np.random.default_rng(1).integers(0, 256, (40, 40, 3), np.uint8)
    assert tg["ext"].face_embed_fn(img).shape == jg["ext"].face_embed_fn(img).shape == (32,)


def _zs_main(zs_root, logdir, *extra):
    argv = ["--zeroshot", "--base", CONFIGS["finetune-ada"], "--data_root", zs_root,
            "--subjects", "a", "b", "--tiny", "--size", "32", "--max_steps", "4",
            "--composition_regs_iter_gap", "2", "--ckpt_every_steps", "2",
            "--logdir", str(logdir)] + list(extra)
    assert ttrain.main(argv, device="cpu") == 0
    return torch.load(os.path.join(logdir, "subj_basis_last.pt"), weights_only=True)


def test_zeroshot_trains_writes_and_resumes(zs_root, tmp_path):
    import json

    whole = _zs_main(zs_root, tmp_path / "whole")
    assert whole["global_step"] == 4 and sorted(whole["generators"]) == ["y", "z"]
    recs = [json.loads(line) for line in open(tmp_path / "whole" / "metrics.jsonl")]
    kinds = [r["iter_type"] for r in recs if "iter_type" in r]
    assert len(kinds) == 4 and "compos_distill" in kinds
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    resumed = _zs_main(zs_root, tmp_path / "resumed", "--resume",
                       str(tmp_path / "whole" / "subj_basis_gs-2.pt"))
    first = torch.load(tmp_path / "whole" / "subj_basis_gs-2.pt", weights_only=True)
    moved = False
    for s in ("y", "z"):
        for k, v in whole["generators"][s].items():
            assert torch.equal(resumed["generators"][s][k], v), (s, k)
            moved |= not torch.equal(first["generators"][s][k], v)
    assert moved


def test_zeroshot_warm_starts_from_a_reference_pt(monkeypatch, zs_root, tmp_path):
    from adaface_tpu_torch.interop.subj_basis import export_subj_basis_generator
    from adaface_tpu_torch.pipeline import build_random
    from tests import torch_serve_helpers as helpers

    # the fg generator run_zero_shot builds under --tiny, from another seed
    got = {}
    with monkeypatch.context() as m:
        m.setattr(tzs_mod, "ZeroShotTrainer", _zs_recorder(got, False))
        with pytest.raises(_Stop):
            ttrain.main(["--zeroshot", "--data_root", zs_root, "--subjects", "a", "b", "--tiny",
                         "--size", "32", "--background_string", "", "--logdir", str(tmp_path)],
                        device="cpu")
    fresh = got["gens"]["z"]
    cfg = fresh.prompt2token_proj.cfg
    src = build_random(lambda: type(fresh)(
        placeholder_is_bg=False, num_out_layers=16, num_out_embs_per_layer=16,
        output_dim=fresh.output_dim, proj_cfg=cfg, pad_token_id=fresh.pad_token_id), 99, "cpu")
    flat = export_subj_basis_generator(src.state_dict(), False)
    D = fresh.output_dim  # a reference fg generator also holds an unread pos_embs LayerNorm
    flat.update({"pos_embs_ln.weight": torch.ones(D), "pos_embs_ln.bias": torch.zeros(D)})
    with helpers.reference_modules():
        mod = helpers.module_from_flat(helpers.SubjBasisGenerator, flat, placeholder_is_bg=False,
                                       num_out_layers=16, num_out_embs_per_layer=16)
        mod.prompt2token_proj.config = helpers.CLIPTextConfigStandIn(
            hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
            num_attention_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
            vocab_size=cfg.vocab_size, max_position_embeddings=cfg.max_position_embeddings,
            layer_norm_eps=cfg.layer_norm_eps)
    pt = str(tmp_path / "embeddings_gs-1.pt")
    helpers.save_reference_embeddings(pt, {}, generators={"z": mod}, token2num={"z": 16})
    warm = {}
    with monkeypatch.context() as m:
        m.setattr(tzs_mod, "ZeroShotTrainer", _zs_recorder(warm, False))
        with pytest.raises(_Stop):
            ttrain.main(["--zeroshot", "--data_root", zs_root, "--subjects", "a", "b", "--tiny",
                         "--size", "32", "--background_string", "", "--logdir", str(tmp_path),
                         "--embedding_manager_ckpt", pt], device="cpu")
    sd = warm["gens"]["z"].state_dict()
    for k, v in src.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert not torch.equal(fresh.state_dict()["pos_embs"], src.state_dict()["pos_embs"])


def _jax_txt2img():
    spec = importlib.util.spec_from_file_location(
        "jax_txt2img_script", os.path.join(ROOT, "scripts", "txt2img.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_compare_with_and_face_sim_score_like_jax(monkeypatch, tmp_path):
    clip_path, dino_path = _hf_files(tmp_path)
    _patch_tiny_configs(monkeypatch)
    monkeypatch.setenv("CLIP_SCORER_PT", clip_path)
    monkeypatch.setenv("DINO_VITS16_PT", dino_path)
    # the port's face-sim recognizer takes the JAX script's (PRNGKey(3))
    cfg = ja.IResNetConfig.tiny()
    jparams = jax.tree_util.tree_map(np.asarray, ja.IResNet(cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))["params"])
    monkeypatch.setattr(ta, "init_iresnet_", lambda m, g: (m.load_state_dict(
        iresnet_state_dict_from_jax(jparams, ta.IResNetConfig.tiny())), m)[1])
    ref = tmp_path / "ref"
    ref.mkdir()
    rng = np.random.default_rng(4)
    for i in range(3):
        png.write(str(ref / f"{i}.png"), rng.integers(0, 256, (40, 36, 3), np.uint8))
    out = tmp_path / "out"
    argv = ["--tiny", "--device", "cpu", "--steps", "2", "--size", "32", "--n_samples", "2",
            "--prompt", "a z person", "--out", str(out), "--compare_with", str(ref),
            "--calc_face_sim", "--class_prompt", "a person"]
    with pytest.warns(UserWarning, match="HashTokenizer"):
        assert tt2i.main(argv) == 0
        tres = tt2i.evaluate(tt2i.parse_args(argv), [("", "a z person", 1)],
                             torch.device("cpu"))
        jres = _jax_txt2img().evaluate(argparse.Namespace(
            outdir=str(out), compare_with=str(ref), class_prompt="a person",
            calc_face_sim=True), [("", "a z person", 1)])
    rows = list(csv.reader(open(out / "scores.csv")))
    # main's row, evaluate's again, JAX's: prompt, CLIP-I, CLIP-T, DINO,
    # face sim, faceless images, their share
    assert len(rows) == 3 and len(rows[0]) == 7 and rows[0] == rows[1] == rows[2]
    assert rows[0][0] == "a person" and rows[0][5] == "0"
    assert sorted(tres) == sorted(jres)
    for k in tres:
        np.testing.assert_allclose(tres[k], jres[k], atol=SCORE_TOL, err_msg=k)
