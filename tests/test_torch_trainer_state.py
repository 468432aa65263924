"""The per-subject trainer's options and state, fp32 on the CPU, on the
tiny pipelines of `test_torch_train_step.py` (one set of weights in both
packages):

- the prompt-delta and embedding regularizer weights under Prodigy and
  AdamW, with and without zero-shot, equal the JAX trainer's; AdamW's rate
  is scaled by accumulation x devices x batch under `scale_lr`;
- `use_remat`: the recon `loss_fn` gradients equal the un-rematerialized
  port's (to 1e-6 of each leaf's largest entry: the recomputed forward is
  the same arithmetic) and JAX's with `use_remat` (at the slice's 2e-4);
  the capture layers are never checkpointed (the compos step's:
  `test_torch_remat.py`);
- `save_checkpoint` writes the EMA shadow, not the live embedders;
- resume: `fit(6)` equals `fit(3)` + `save_state` + a new trainer +
  `load_state` + `fit(6)` bit for bit, at the shipped gap 3, under Prodigy
  and under AdamW with EMA;
- a SIGUSR1 sent to the process writes a checkpoint at the end of the step
  it arrives in."""

import contextlib
import copy
import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

import jax

from adaface_tpu.training import train_step as jts
from adaface_tpu.training.iter_plan import IterPlanConfig as JPlanConfig
from adaface_tpu.training.trainer import Trainer as JTrainer
from adaface_tpu.training.trainer import TrainerConfig as JTrainerConfig
from adaface_tpu.data.personalized import PersonalizedDataset as JDataset
from adaface_tpu.data.personalized import SubjectSpec as JSpec

from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec
from adaface_tpu_torch.personalization.static_embedding import embedder_leaves
from adaface_tpu_torch.training import train_step as tts
from adaface_tpu_torch.training.iter_plan import IterPlanConfig
from adaface_tpu_torch.training.trainer import Trainer, TrainerConfig

from test_torch_train_step import (  # noqa: F401
    STEP_KW,
    _assert_grads_close,
    _batch,
    _port_embedders,
    pipes,
    subject_dir,
)

torch.set_num_threads(2)
PLAN_KW = dict(composition_regs_iter_gap=3, do_zero_shot=False,
               prompt_emb_delta_reg_weight=2e-4, mix_prompt_distill_weight=2e-4,
               arc2face_distill_iter_prob=0.0)


@contextlib.contextmanager
def _restored_embedders(tp):
    """The shared port embedders put back as they were (values, no grad)."""
    before = {s: {n: t.detach().clone() for n, t in embedder_leaves(p)}
              for s, p in tp.embedding_manager.embedders.items()}
    try:
        yield
    finally:
        with torch.no_grad():
            for s, p in tp.embedding_manager.embedders.items():
                for n, t in embedder_leaves(p):
                    t.requires_grad_(False)
                    t.copy_(before[s][n])


def _trainer(tp, subject_dir, logdir, **cfg):
    kw = dict(batch_size=2, max_steps=6, seed=2, log_every_steps=1000, ckpt_every_steps=1000)
    kw.update(cfg)
    return Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                   TrainerConfig(logdir=str(logdir), **kw), IterPlanConfig(**PLAN_KW))


@pytest.mark.parametrize("use_prodigy", [True, False])
@pytest.mark.parametrize("zero_shot", [False, True])
def test_regularizer_weights_follow_the_optimizer(pipes, subject_dir, tmp_path, use_prodigy,
                                                  zero_shot):
    jp, tp = pipes
    cfg = dict(use_prodigy=use_prodigy, learning_rate=4e-3, batch_size=3,
               accumulate_grad_batches=2, log_every_steps=1000)
    plan = dict(PLAN_KW, do_zero_shot=zero_shot)
    jtr = JTrainer(jp, JDataset([JSpec("s", subject_dir)], size=32, seed=0),
                   JTrainerConfig(logdir=str(tmp_path / "j"), **cfg), JPlanConfig(**plan))
    with _restored_embedders(tp):
        ttr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                      TrainerConfig(logdir=str(tmp_path / "t"), **cfg), IterPlanConfig(**plan))
        ttr.close()
    assert ttr._delta_w == pytest.approx(jtr._delta_w, rel=1e-12)
    assert ttr._emb_reg_w == pytest.approx(jtr._emb_reg_w, rel=1e-12)
    damping = 0.5 if use_prodigy else 1.0
    assert ttr._delta_w == pytest.approx(2e-4 * damping / (5 if zero_shot else 1))
    if not use_prodigy:
        assert type(ttr.optimizer.inner).__name__ == "AdamW"
        assert ttr.optimizer.inner.lr == pytest.approx(4e-3 * 2 * 1 * 3)
        with _restored_embedders(tp):
            unscaled = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32,
                                                       seed=0),
                               TrainerConfig(logdir=str(tmp_path / "u"), scale_lr=False,
                                             **cfg), IterPlanConfig(**plan))
            unscaled.close()
        assert unscaled.optimizer.inner.lr == 4e-3


@contextlib.contextmanager
def _remat(unet, on=True):
    cfg = unet.cfg
    unet.cfg = dataclasses.replace(cfg, use_remat=on)
    try:
        yield
    finally:
        unet.cfg = cfg


def _jax_with_remat(jp):
    jpr = copy.copy(jp)
    jpr.unet = type(jp.unet)(dataclasses.replace(jp.unet.cfg, use_remat=True), jp.unet.dtype)
    return jpr


def _spy_checkpoint(monkeypatch, tp):
    """Names of the UNet blocks that go through torch.utils.checkpoint."""
    names = {m: n for n, m in tp.unet.named_children()}
    seen = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *a, **k):
        seen.append(names[fn])
        return real(fn, *a, **k)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    return seen


def _leaf_grads(emb):
    return {(s, n): t.grad.clone() for s in sorted(emb) for n, t in embedder_leaves(emb[s])}


def _same_grads(a, b, tol=1e-6):
    assert a.keys() == b.keys()
    for k in a:
        scale = float(b[k].abs().max())
        assert scale > 0, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=tol * scale)


def test_remat_recon_gradients(monkeypatch, pipes):
    jp, tp = pipes
    jb, tb = _batch(jp, np.random.default_rng(4), [640, 75])
    step = tts.make_recon_train_step(tp.clip, tp.unet, tp.base_sched, None, **STEP_KW)
    emb = _port_embedders(tp)
    plain_loss, _ = step.loss_fn(emb, tb)
    plain_loss.backward()
    plain = _leaf_grads(emb)
    seen = _spy_checkpoint(monkeypatch, tp)
    with _remat(tp.unet):
        emb = _port_embedders(tp)
        loss, _ = step.loss_fn(emb, tb)
        loss.backward()
    # every spatial transformer but the capture layers' is checkpointed
    spatial = [n for n, _ in tp.unet.named_children() if "attn" in n]
    assert seen and set(seen) < set(spatial)
    captured = {n for n in spatial if n in ("up_0_attn_0", "up_0_attn_1")}  # layers 7, 8
    assert captured and not captured & set(seen)
    assert loss.item() == pytest.approx(plain_loss.item(), rel=1e-6)
    _same_grads(_leaf_grads(emb), plain)
    jstep = jts.make_recon_train_step(jp.clip, jp.clip_params, _jax_with_remat(jp).unet,
                                      jp.unet_params, jp.base_sched, None, **STEP_KW)
    vg = jax.jit(jax.value_and_grad(jstep.loss_fn, has_aux=True))
    (jloss, _), jgrads = vg(jp.embedding_manager.embedders, jb,
                            {"clip": jp.clip_params, "unet": jp.unet_params})
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    _assert_grads_close(emb, jgrads)


def test_save_checkpoint_writes_the_ema_shadow(pipes, subject_dir, tmp_path):
    """EMA on, decay 0.5: after two steps that each move every leaf by +1
    (stand-in steps), the shadow lags the live embedders; the checkpoint
    holds the shadow, at the warm-up decay min(0.5, (1+n)/(10+n))."""
    _, tp = pipes
    with _restored_embedders(tp):
        start = {s: {n: t.detach().clone() for n, t in embedder_leaves(p)}
                 for s, p in tp.embedding_manager.embedders.items()}
        tr = _trainer(tp, subject_dir, tmp_path, use_ema=True, ema_decay=0.5,
                      max_steps=2)

        def step(emb, batch):
            with torch.no_grad():
                for p in emb.values():
                    for _, t in embedder_leaves(p):
                        t.add_(1.0)
            return {}

        tr._get_recon_step = tr._get_compos_step = lambda *a: step
        tr.fit()
        tr.close()
        saved = np.load(tmp_path / "embeddings_last.npz")
        d1, d2 = 2 / 11, 3 / 12  # the warm-up decays of updates 1 and 2
        for s, p in tp.embedding_manager.embedders.items():
            for n, t in embedder_leaves(p):
                live = t.detach().numpy()
                np.testing.assert_allclose(live, start[s][n].numpy() + 2, rtol=1e-6)
                # shadow_1 = s0 + (1 - d1), shadow_2 = shadow_1 + (1 - d2)(s0 + 2 - shadow_1)
                sh1 = start[s][n].numpy() + (1 - d1)
                sh2 = sh1 + (1 - d2) * (start[s][n].numpy() + 2 - sh1)
                np.testing.assert_allclose(saved[f"{s}::{n}"], sh2, rtol=1e-5, atol=1e-6)
                assert not np.allclose(saved[f"{s}::{n}"], live)


@pytest.mark.parametrize("opt", ["prodigy", "adamw_ema"])
def test_resume_is_bit_for_bit(pipes, subject_dir, tmp_path, opt):
    """fit(6) at gap 3 (compos at 0 and 3) against fit(3), save_state, a new
    trainer, load_state, fit(6): the embedders, the optimizer state and the
    EMA shadow end equal bit for bit, and so do the logged metrics."""
    import json

    _, tp = pipes
    cfg = dict(use_prodigy=opt == "prodigy", use_ema=opt != "prodigy", ema_decay=0.9,
               learning_rate=1e-3)

    def final(tr):
        out = {(s, n): t.detach().clone() for s, p in tr.mgr.embedders.items()
               for n, t in embedder_leaves(p)}
        state = tr.optimizer.state_dict()
        flat = [v for k in sorted(state["inner"]) for v in (
            state["inner"][k] if isinstance(state["inner"][k], list) else [state["inner"][k]])]
        if tr.ema_state is not None:
            flat += [t for p in tr.ema_state.shadow.values() for _, t in embedder_leaves(p)]
        return out, flat

    def metrics(logdir):
        return [json.loads(line) for line in open(logdir / "metrics.jsonl") if '"loss"' in line]

    with _restored_embedders(tp):
        whole = _trainer(tp, subject_dir, tmp_path / "whole", **cfg)
        whole.fit()
        whole.close()
        want, want_state = final(whole)
    with _restored_embedders(tp):
        first = _trainer(tp, subject_dir, tmp_path / "split", **cfg)
        first.fit(3)
        path = first.save_state()
        first.close()
        second = _trainer(tp, subject_dir, tmp_path / "split", **cfg)
        second.load_state(path)
        assert second.global_step == 3
        second.fit()
        second.close()
        got, got_state = final(second)
    assert tp.embedding_manager.embedders  # restored for the other tests
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert len(got_state) == len(want_state)
    for a, b in zip(got_state, want_state):
        if torch.is_tensor(a):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert a == b
    assert metrics(tmp_path / "split") == metrics(tmp_path / "whole")
    assert [m["iter_type"] for m in metrics(tmp_path / "whole")] == [
        "compos_distill", "recon", "recon", "compos_distill", "recon", "recon"]


def test_sigusr1_writes_a_checkpoint_at_the_next_step(pipes, subject_dir, tmp_path):
    _, tp = pipes
    with _restored_embedders(tp):
        tr = _trainer(tp, subject_dir, tmp_path, max_steps=3)
        calls = []

        def step(emb, batch):
            calls.append(1)
            if len(calls) == 2:  # arrives during step 1
                os.kill(os.getpid(), signal.SIGUSR1)
            return {}

        tr._get_recon_step = tr._get_compos_step = lambda *a: step
        tr.fit()
        tr.close()
    files = sorted(f for f in os.listdir(tmp_path) if f.startswith("embeddings_"))
    assert files == ["embeddings_gs-2.npz", "embeddings_last.npz"]
    assert not tr._sig_ckpt_requested
