"""Port parity of the CLIP teacher filter and the reuse-init cache, fp32 on
the CPU, against `adaface_tpu/training/teacher_filter.py` and the JAX
trainers.

- `TeacherFilter.filter` on the tiny UNet and VAE of
  `test_torch_train_step.py` (weights carried over), at CB 1 and CB 2 (2
  candidates, cand-major rows), with a scorer that maps each image's mean to
  a CLIP-T value: the uint8 images within 1 of JAX's, the x0 reconstructions
  within 1e-4 of the largest value, the losses within 1e-4 (a pixel that
  truncates the other way moves a loss by 2e-5), the verdict and
  `per_block` equal. `per_block` alone on losses that make one block of two
  teachable and the other a fallback, equal to JAX's.
- The trainers: from one seed, JAX's `Trainer` and the port's, each with
  `set_teacher_filter` on a scorer that switches verdicts, run three compos
  iterations with their real steps: unteachable (skipped, embedders
  untouched, the host RNG where JAX's is), teachable (the best of 2
  candidates trains; the loss within TRAIN_LOSS_TOL relative of JAX's; the
  cache entry's reconstruction within 1e-4, t, prompts and flags equal), and
  reuse-init (the entry popped, the loss within TRAIN_LOSS_TOL). The same
  for both `ZeroShotTrainer`s on the fixture of `test_torch_zs_train.py`,
  whose cache entry also holds the reference features and identity that
  the reuse-init iteration restores.

TRAIN_LOSS_TOL is 1e-4 relative: both sides run fp32, and the filter's
reconstructions (which become x_start on the reuse-init iteration) differ by
fp32 rounding of the candidate denoise.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaface_tpu.data.personalized import PersonalizedDataset as JDataset
from adaface_tpu.data.personalized import SubjectSpec as JSpec
from adaface_tpu.training import teacher_filter as jtf
from adaface_tpu.training.iter_plan import COMPOS_DISTILL as J_COMPOS
from adaface_tpu.training.iter_plan import IterPlanConfig as JPlanConfig
from adaface_tpu.training.iter_plan import plan_iteration as j_plan_iteration
from adaface_tpu.training.trainer import Trainer as JTrainer
from adaface_tpu.training.trainer import TrainerConfig as JTrainerConfig

from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec
from adaface_tpu_torch.training import teacher_filter as ttf
from adaface_tpu_torch.training.iter_plan import COMPOS_DISTILL, IterPlanConfig, plan_iteration
from adaface_tpu_torch.training.trainer import Trainer, TrainerConfig

from test_torch_train_step import PLAN_KW, pipes, subject_dir  # noqa: F401
from test_torch_zs_train import _trainers as zs_trainers
from test_torch_zs_train import zs  # noqa: F401

torch.set_num_threads(2)

TRAIN_LOSS_TOL = 1e-4
N_CAND = 2


class MeanScorer:
    """CLIP-T stand-in: 0.25 + 4 x (each image's mean / 255 - 0.5)."""

    def txt_to_img_similarity(self, prompts, images, reduction="diag"):
        assert reduction == "diag" and len(prompts) == len(images)
        m = np.asarray(images, np.float64).reshape(len(images), -1).mean(1) / 255
        return 0.25 + 4.0 * (m - 0.5)


class SwitchScorer:
    """Fixed CLIP-T values per row, set per iteration."""

    def __init__(self):
        self.sims = [0.2, 0.2, 0.3, 0.3]

    def txt_to_img_similarity(self, prompts, images, reduction="diag"):
        assert reduction == "diag" and len(prompts) == len(self.sims)
        return np.asarray(self.sims, np.float32)


# row sims (subj-comp candidates, then mix-comp ones) per iteration kind:
# mix loss 0.4 > 0.28 (unteachable); candidate 1 has the larger gap
UNTEACHABLE = [0.2, 0.2, 0.1, 0.1]
TEACHABLE = [0.2, 0.1, 0.25, 0.3]


def _filters(pipes, scorer):
    jp, tp = pipes
    return (jtf.TeacherFilter(scorer, jp.unet, jp.unet_params, jp.vae, jp.vae_params,
                              jp.base_sched),
            ttf.TeacherFilter(scorer, tp.unet, tp.vae, tp.base_sched))


@pytest.mark.parametrize("CB", [1, 2])
def test_filter_matches_jax(pipes, CB):
    N = N_CAND * CB
    rng = np.random.default_rng(CB)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, noise = f(N, 8, 8, 4), f(N, 8, 8, 4)
    t = rng.integers(0, 1000, N).astype(np.int32)
    sv, sk, mv, mk = (0.5 * f(16, N, 77, 64) for _ in range(4))
    un = 0.5 * f(1, N, 77, 64)
    prompts = [f"a person in scene {i}" for i in range(N)]
    jf, tf = _filters(pipes, MeanScorer())
    jv = jf.filter(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t),
                   (jnp.asarray(sv), jnp.asarray(sk)), (jnp.asarray(mv), jnp.asarray(mk)),
                   jnp.asarray(un), prompts)
    T = torch.from_numpy
    tv = tf.filter(T(x), T(noise), T(t), (T(sv), T(sk)), (T(mv), T(mk)), T(un), prompts)
    assert tv.images.shape == jv.images.shape == (2 * N, 16, 16, 3)
    assert np.abs(tv.images.astype(int) - jv.images.astype(int)).max() <= 1
    ref = np.asarray(jv.x_recons)
    np.testing.assert_allclose(tv.x_recons.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    np.testing.assert_allclose(tv.losses_subj_comp, jv.losses_subj_comp, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tv.losses_mix_comp, jv.losses_mix_comp, atol=1e-4, rtol=0)
    assert (tv.is_teachable, tv.best_cand_idx) == (jv.is_teachable, jv.best_cand_idx)
    for a, b in zip(tf.per_block(tv, N_CAND, CB), jf.per_block(jv, N_CAND, CB)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("margin", [0.002, 0.05])
def test_per_block_matches_jax(pipes, margin):
    """Block 0 teachable (its 2nd candidate the larger gap), block 1 not
    (a fallback: its best-scoring candidate)."""
    l_subj = np.asarray([0.30, 0.26, 0.45, 0.40], np.float32)  # cand-major, CB 2
    l_mix = np.asarray([0.27, 0.41, 0.20, 0.30], np.float32)
    out = []
    for tf, V in zip(_filters(pipes, None)[::-1], (ttf.FilterVerdict, jtf.FilterVerdict)):
        tf.cls_subj_clip_margin = margin
        out.append(tf.per_block(V(False, 0, l_subj, l_mix, None), 2, 2))
    for a, b in zip(*out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ok, best, block_ok = out[0]
    assert ok and list(best) == [1, 1] and list(block_ok) == [True, False]


def _plans(n=20):
    """The same compos plan in both packages (plan RNGs of their own), the
    filter on, no bg token, fp trick or embedding noise (JAX draws that
    noise from a PRNG key, the port from a torch generator)."""
    kw = dict(PLAN_KW, composition_regs_iter_gap=1)
    jcfg, tcfg = JPlanConfig(**kw), IterPlanConfig(**kw)
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for step in range(n):
        jplan = j_plan_iteration(jrng, step, jcfg)
        tplan = plan_iteration(trng, step, tcfg)
        assert jplan.iter_type == tplan.iter_type
        if tplan.iter_type == COMPOS_DISTILL:
            assert jplan.iter_type == J_COMPOS
            for p in (jplan, tplan):
                p.do_teacher_filter, p.use_background_token, p.use_fp_trick = True, False, False
                p.emb_noise_std = 0.0
            return jplan, tplan
    raise AssertionError("no compos plan")


def _check_entry(tentry, jentry):
    ref = np.asarray(jentry["x_start"])
    np.testing.assert_allclose(tentry["x_start"], ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    for k in ("t", "fg_mask"):
        np.testing.assert_array_equal(np.asarray(tentry[k]), np.asarray(jentry[k]), err_msg=k)
    for k in ("prompts", "use_background_token", "comp_init_fg_from_training_image",
              "use_wds_comp"):
        assert tentry[k] == jentry[k], k


def _run_branches(jtr, ttr, jscorer, tscorer, jrun, trun, tparams, check_extra=None):
    """Unteachable, teachable and reuse-init compos iterations in both
    trainers; returns the teachable and reuse-init losses (JAX, port)."""
    losses = []
    for kind, sims in (("unteachable", UNTEACHABLE), ("teachable", TEACHABLE),
                       ("reuse", TEACHABLE)):
        jscorer.sims = tscorer.sims = sims
        jplan, tplan = _plans()
        before = copy.deepcopy(tparams())
        jm, tm = jrun(jplan), trun(tplan)
        assert tplan.reuse_init_conds == jplan.reuse_init_conds == (kind == "reuse")
        assert ttr.rng.bit_generator.state == jtr.rng.bit_generator.state, kind
        if kind == "unteachable":
            assert tm["skipped_unteachable"] == jm["skipped_unteachable"] == 1.0
            for a, b in zip(before, tparams()):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            assert "s" not in ttr.cached_inits and "s" not in jtr.cached_inits
            continue
        assert "skipped_unteachable" not in tm
        losses.append((float(jm["loss"]), float(tm["loss"])))
        np.testing.assert_allclose(losses[-1][1], losses[-1][0], rtol=TRAIN_LOSS_TOL,
                                   err_msg=kind)
        if kind == "teachable":
            _check_entry(ttr.cached_inits.peek("s"), jtr.cached_inits.peek("s"))
            if check_extra is not None:
                check_extra(ttr.cached_inits.peek("s"), jtr.cached_inits.peek("s"))
        else:
            assert "s" not in ttr.cached_inits and "s" not in jtr.cached_inits
    return losses


def _leaves(embedders):
    from adaface_tpu_torch.personalization.static_embedding import embedder_leaves

    return [t.detach().clone() for s in sorted(embedders) for _, t in
            embedder_leaves(embedders[s])]


def test_trainer_filter_branches_match_jax(pipes, subject_dir, tmp_path):
    jp, tp = pipes
    jp = copy.copy(jp)
    jp.embedding_manager = copy.deepcopy(jp.embedding_manager)
    tp = copy.copy(tp)
    tp.embedding_manager = copy.deepcopy(tp.embedding_manager)
    cfg = dict(batch_size=1, max_steps=20, seed=2, log_every_steps=1000, ckpt_every_steps=1000,
               accumulate_grad_batches=1)
    jtr = JTrainer(jp, JDataset([JSpec("s", subject_dir)], size=32, seed=0),
                   JTrainerConfig(logdir=str(tmp_path / "j"), **cfg), JPlanConfig(**PLAN_KW))
    ttr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                  TrainerConfig(logdir=str(tmp_path / "t"), **cfg), IterPlanConfig(**PLAN_KW))
    js, ts = SwitchScorer(), SwitchScorer()
    jtr.set_teacher_filter(js)
    ttr.set_teacher_filter(ts)
    losses = _run_branches(jtr, ttr, js, ts, jtr._run_compos, ttr._run_compos,
                           lambda: _leaves(ttr.mgr.embedders))
    ttr.close()
    assert len(losses) == 2


def test_zs_trainer_filter_branches_match_jax(zs, subject_dir, tmp_path):
    jtr, ttr = zs_trainers(zs, subject_dir, tmp_path, batch_size=1, accumulate_grad_batches=1)
    js, ts = SwitchScorer(), SwitchScorer()
    jtr.set_teacher_filter(js)
    ttr.set_teacher_filter(ts)
    def check_extra(tentry, jentry):
        for k in ("clip_fg", "clip_bg"):
            np.testing.assert_allclose(getattr(tentry["zs_feats"], k).numpy(),
                                       np.asarray(getattr(jentry["zs_feats"], k)), atol=1e-4,
                                       rtol=0, err_msg=k)
        np.testing.assert_array_equal(tentry["zs_id_embs"], np.asarray(jentry["zs_id_embs"]))

    losses = _run_branches(
        jtr, ttr, js, ts, jtr._run_zs_compos, ttr._run_zs_compos,
        lambda: [p.detach().clone() for s in sorted(ttr.generators)
                 for p in ttr.generators[s].parameters()], check_extra)
    ttr.close()
    assert len(losses) == 2
