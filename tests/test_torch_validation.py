"""Validation in both of the port's trainers against JAX's, fp32 on the CPU.

- `Trainer.run_validation`: on the tiny pipelines of
  `test_torch_train_step.py`, from one seed, the `val/` rows (the recon
  battery without gradients: recon, the embedding regularizer, the
  suppression and cross-layer terms; with EMA on, the `_ema` arm) equal
  JAX's at rtol 1e-5, called directly and at the `val_every_steps` cadence
  inside `fit` (the steps replaced by recorders, so the embedders stay
  put).
- `ZeroShotTrainer.run_validation`: the same on the zero-shot fixture of
  `test_torch_zs_train.py` (no dropout; identities the val stream draws).
- Validation draws from its own RNGs: a run with `val_every_steps` builds
  the same training batches as one without, and ends with the same RNG
  states.
- With an image logger the pass writes a `val_samples` grid, a PNG of the
  pipeline's own images."""

import json

import numpy as np
import pytest
import torch

from adaface_tpu.data.personalized import PersonalizedDataset as JDataset
from adaface_tpu.data.personalized import SubjectSpec as JSpec
from adaface_tpu.training.iter_plan import IterPlanConfig as JPlanConfig
from adaface_tpu.training.trainer import Trainer as JTrainer
from adaface_tpu.training.trainer import TrainerConfig as JTrainerConfig

from adaface_tpu_torch.data import png
from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec
from adaface_tpu_torch.training.image_logger import make_grid
from adaface_tpu_torch.training.iter_plan import IterPlanConfig
from adaface_tpu_torch.training.trainer import Trainer, TrainerConfig

import test_torch_zs_train as z
from test_torch_train_step import PLAN_KW, pipes, subject_dir  # noqa: F401
from test_torch_zs_train import zs  # noqa: F401

torch.set_num_threads(2)
CFG = dict(batch_size=2, max_steps=100, seed=3, log_every_steps=1000, ckpt_every_steps=1000,
           val_every_steps=2, val_batches=2)


def _static(pipes, subject_dir, tmp_path, **kw):
    jp, tp = pipes
    cfg = dict(CFG, **kw)
    plan = dict(PLAN_KW, composition_regs_iter_gap=0)
    jtr = JTrainer(jp, JDataset([JSpec("s", subject_dir)], size=32, seed=0),
                   JTrainerConfig(logdir=str(tmp_path / "j"), **cfg), JPlanConfig(**plan))
    ttr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                  TrainerConfig(logdir=str(tmp_path / "t"), **cfg), IterPlanConfig(**plan))
    return jtr, ttr


def _same_rows(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    assert got["step"] == want["step"]
    for k in want:
        if k != "step":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8, err_msg=k)


def _val_rows(path):
    return [r for r in map(json.loads, open(path)) if any(k.startswith("val/") for k in r)]


def _record(jtr, ttr):
    jrec, trec = [], []
    jtr._get_recon_step = lambda *a: (lambda e, o, b, f=None: (jrec.append(b) or (e, o, {})))
    ttr._get_recon_step = lambda *a: (lambda e, b: (trec.append(b) or {}))
    return jrec, trec


@pytest.mark.parametrize("use_ema", [False, True])
def test_static_validation_matches_jax(pipes, subject_dir, tmp_path, use_ema):
    jtr, ttr = _static(pipes, subject_dir, tmp_path, use_ema=use_ema)
    want, got = jtr.run_validation(), ttr.run_validation()
    _same_rows(got, want)
    assert {"val/recon", "val/subj_mb_suppress", "val/fg_xlayer_consist"} <= set(got)
    assert ("val/recon_ema" in got) == use_ema
    _record(jtr, ttr)  # the cadence inside fit, embedders held still
    jtr.fit(4)
    ttr.fit(4)
    ttr.close()
    jrows, trows = _val_rows(tmp_path / "j" / "metrics.jsonl"), \
        _val_rows(tmp_path / "t" / "metrics.jsonl")
    assert [r["step"] for r in trows] == [0, 2, 4]
    for a, b in zip(trows, jrows):
        _same_rows(a, b)


def test_validation_leaves_the_training_stream(pipes, subject_dir, tmp_path):
    """fit(4) with validation every 2 steps draws the batches of a fit(4)
    without it, and leaves every training RNG where that run leaves it."""
    _, with_val = _static(pipes, subject_dir, tmp_path / "a")
    _, without = _static(pipes, subject_dir, tmp_path / "b", val_every_steps=0)
    recs = []
    for tr in (with_val, without):
        rec = _record(tr, tr)[1]
        tr.fit(4)
        tr.close()
        recs.append(rec)
    for a, b in zip(*recs):
        for name in ("token_ids", "timesteps", "noise", "fg_mask", "delta_token_ids"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)), err_msg=name)
    for attr in ("rng", "sampler"):
        a, b = getattr(with_val, attr), getattr(without, attr)
        a, b = (a, b) if attr == "rng" else (a.rng, b.rng)
        assert a.bit_generator.state == b.bit_generator.state
    assert with_val.dataset.rng.bit_generator.state == without.dataset.rng.bit_generator.state
    assert len(_val_rows(tmp_path / "a" / "t" / "metrics.jsonl")) == 2
    assert not _val_rows(tmp_path / "b" / "t" / "metrics.jsonl")


def test_validation_writes_a_sample_grid(pipes, subject_dir, tmp_path):
    _, tr = _static(pipes, subject_dir, tmp_path, val_batches=1)
    tr.set_image_logger(every_steps=2, num_samples=2, sample_steps=2, size=32)
    calls = []
    real = tr.pipe.generate

    def generate(*a, **k):
        calls.append(real(*a, **k))
        return calls[-1]

    tr.pipe.generate = generate
    try:
        tr.run_validation()
    finally:
        del tr.pipe.generate
        tr.close()
    grid = png.read(str(tmp_path / "t" / "images" / "val_samples_gs-000000.png"))
    assert grid.shape == (32, 4 * 32, 3)
    np.testing.assert_array_equal(grid, make_grid(list(calls[0])))


def test_zero_shot_validation_matches_jax(zs, subject_dir, tmp_path):
    jtr, ttr = z._trainers(zs, subject_dir, tmp_path, val_every_steps=2, val_batches=2)
    want, got = jtr.run_validation(), ttr.run_validation()
    _same_rows(got, want)
    assert {"val/recon", "val/loss"} <= set(got)
    jrec, trec = z._recording(jtr, ttr)
    jtr.fit(4)
    ttr.fit(4)
    ttr.close()
    jrows, trows = _val_rows(tmp_path / "j" / "metrics.jsonl"), \
        _val_rows(tmp_path / "t" / "metrics.jsonl")
    assert [r["step"] for r in trows] == [0, 2, 4]
    for a, b in zip(trows, jrows):
        _same_rows(a, b)
    assert len(trec) == len(jrec) == 4
    for jb, tb in zip(jrec, trec):
        z._same(tb.noise, jb.noise, "noise")
        z._same(tb.timesteps, jb.timesteps, "timesteps")
