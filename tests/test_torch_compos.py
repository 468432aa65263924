"""Port parity of compositional distillation, fp32 on the CPU.

- Every loss function the compositional battery adds (`training/losses.py`)
  against its JAX twin on the same numpy inputs, values and, for the
  layer-level batteries, gradients; the antialiased resize of
  `jax.image.resize` at 64->31, 32->15 and 16->7; the mixing, compel and
  x-init functions, compel and x-init drawing from the same numpy seed.
- The compositional `loss_fn` on the tiny pipeline of
  `test_torch_train_step.py` (a 16x16 latent, so the distillation layers 7
  and 8 capture 16x16 maps and the level-0 self-attention, L256, goes
  through the flash path: Pallas in interpret mode in JAX, the kernels'
  plain versions in the port): every metric and every embedder leaf's
  gradient against `jax.value_and_grad`, with fg-init, compel and the bg
  token on, and the two regularizers that ship disabled on in a second
  case.
- The trainers: from one seed both build the same `ComposBatch` arrays over
  a gap-3 `fit` (compos steps 0, 3 and 6, recon between), the first a
  reuse-init iteration from a `CachedInits` entry seeded into both.

Tolerances: metrics 1e-5 relative, gradients 2e-4 of each leaf's largest
entry, as the recon slice's; loss functions alone 1e-5 relative (values)
and 1e-4 of the largest entry (gradients); latents 1e-4, as the recon
slice's. Two stand-in errors are shown to fall outside them: the resize
without antialias, and a ddof-1 std in the preserve battery's channel
LayerNorm (held at the normalized features: the battery's terms are
cosines, which a uniform rescale of every feature cannot move)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from adaface_tpu.data.personalized import PersonalizedDataset as JDataset
from adaface_tpu.data.personalized import SubjectSpec as JSpec
from adaface_tpu.models.clip_text import CLIPTextEncoder as JCLIPTextEncoder
from adaface_tpu.ops import compel as jcompel
from adaface_tpu.personalization.embedding_manager import EmbeddingManager as JEM
from adaface_tpu.personalization.static_embedding import compute_static_embedding as j_static
from adaface_tpu.training import losses as jl
from adaface_tpu.training import mixing as jmix
from adaface_tpu.training import train_step as jts
from adaface_tpu.training import x_init as jx
from adaface_tpu.training.iter_plan import IterPlanConfig as JPlanConfig
from adaface_tpu.training.teacher_filter import CachedInits as JCachedInits
from adaface_tpu.training.trainer import Trainer as JTrainer
from adaface_tpu.training.trainer import TrainerConfig as JTrainerConfig

from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec
from adaface_tpu_torch.ops import compel as tcompel
from adaface_tpu_torch.training import losses as tl
from adaface_tpu_torch.training import mixing as tmix
from adaface_tpu_torch.training import train_step as tts
from adaface_tpu_torch.training import x_init as tx
from adaface_tpu_torch.training.iter_plan import IterPlanConfig
from adaface_tpu_torch.training.teacher_filter import CachedInits
from adaface_tpu_torch.training.trainer import Trainer, TrainerConfig

from test_torch_train_step import (  # noqa: F401
    _assert_grads_close,
    _port_embedders,
    pipes,
    subject_dir,
)

torch.set_num_threads(2)

RTOL = 1e-5
GRAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, rtol=RTOL, atol=1e-7, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def _grads_close(got, ref, tol=GRAD_TOL):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        scale = np.abs(r).max()
        assert scale > 0
        np.testing.assert_allclose(g.numpy(), r, atol=tol * scale, rtol=0)


def _rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ------------------------------------------------------------ loss functions
def test_small_helpers_match():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    _close(tl.cosine_loss(_t(a), _t(b)), jl.cosine_loss(a, b))
    _close(tl.calc_align_coeffs(_t(a), _t(b)), jl.calc_align_coeffs(a, b))
    _close(tl.ortho_l2loss(_t(a), _t(b)), jl.ortho_l2loss(a, b))
    _close(tl.normalized_ortho_subtract(_t(a), _t(b)), jl.normalized_ortho_subtract(a, b),
           atol=1e-6)
    for v in (0.0, 0.1, 0.5, 3.0):
        for args in ((0.2, 2.0, 1.0, 3.0), (5.0, 0.2), (0.0, 1.0)):
            assert tl.calc_dyn_loss_scale(v, *args) == pytest.approx(
                jl.calc_dyn_loss_scale(v, *args))
            _close(tl.dyn_loss_scale(torch.tensor(v), *args), jl.dyn_loss_scale(jnp.float32(v),
                                                                                 *args))
    seq = rng.standard_normal((4, 10, 8)).astype(np.float32)
    m, w = (rng.random(10) > 0.5).astype(np.float32), rng.random(10).astype(np.float32)
    _close(tl._weighted_token_mean(_t(seq), _t(m), _t(w)), jl._weighted_token_mean(seq, m, w),
           atol=1e-6)
    pm, sm, bm = (rng.random((3, 2, 10)) > 0.4).astype(np.float32)
    _close(tl.comp_extra_token_mask(_t(pm), _t(sm), _t(bm)), jl.comp_extra_token_mask(pm, sm, bm))
    x = rng.standard_normal((2, 6, 16, 16)).astype(np.float32)
    for k, s in ((4, 2), (8, 4)):
        _close(tl._avg_pool_nc(_t(x), k, s), jl._avg_pool_nc(jnp.asarray(x), k, s), atol=1e-6)


@pytest.mark.parametrize("margin", [0.0, 0.3])
def test_ref_cosine_margin_matches(margin):
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((2, 3, 7, 12)).astype(np.float32)
    w = rng.random((3, 7)).astype(np.float32)
    for kw in ({}, {"emb_weights": w}, {"emb_weights": w, "instance_axis": 0}):
        _close(tl.ref_cosine_loss(_t(a), _t(b), margin=margin, **{
            k: _t(v) if k == "emb_weights" else v for k, v in kw.items()}),
            jl.ref_cosine_loss(a, b, margin=margin, **kw), msg=str(kw))


def test_delta_alignment_matches():
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((4, 3, 9, 16)).astype(np.float32)
    got = tl.delta_alignment_loss(*map(_t, xs))
    ref = jl.delta_alignment_loss(*xs)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k], msg=k)


@pytest.mark.parametrize("s_in,s_out", [(16, 16), (16, 8), (8, 16), (64, 31)])
def test_spatial_weight_matches(s_in, s_out):
    rng = np.random.default_rng(3)
    a = rng.random((2, 4, s_in * s_in)).astype(np.float32)
    _close(tl.convert_attn_to_spatial_weight(_t(a), (s_out, s_out)),
           jl.convert_attn_to_spatial_weight(jnp.asarray(a), (s_out, s_out)), atol=1e-6)


@pytest.mark.parametrize("s_in,s_out", [(64, 31), (32, 15), (16, 7), (16, 32)])
def test_resize_matches_jax_image_resize(s_in, s_out):
    """The resize of the compositional losses against `jax.image.resize`
    (bilinear, antialiased when it shrinks) at the preserve battery's three
    pooled sizes and one upsample; the 2-tap resize without antialias (the
    port's recon-battery resize, and `F.interpolate`'s default) is a
    stand-in error that must fall outside the tolerance when shrinking."""
    rng = np.random.default_rng(4)
    x = rng.random((3, 2, s_in, s_in)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (3, 2, s_out, s_out), "bilinear")
    _close(tl.resize_aa(_t(x), s_out, s_out), ref, atol=1e-6)
    plain = F.interpolate(_t(x), (s_out, s_out), mode="bilinear", align_corners=False)
    if s_out < s_in:
        assert _rel(plain, ref) > 10 * RTOL
        assert _rel(tl._bilinear_2tap(_t(x).reshape(6, s_in, s_in), s_out, s_out)
                    .reshape(3, 2, s_out, s_out), ref) > 10 * RTOL


def _mix_layer_inputs(rng, hw, c=24, h=4):
    outfeat = rng.standard_normal((4, hw, hw, c)).astype(np.float32)
    attn = rng.random((4, h, hw * hw)).astype(np.float32)
    return outfeat, attn


@pytest.mark.parametrize("hw", [8, 16, 32, 64])
def test_prompt_mix_layer_losses_match(hw):
    """Values and the gradients of their sum, at every map size of the
    pooler table."""
    rng = np.random.default_rng(5 + hw)
    outfeat, attn = _mix_layer_inputs(rng, hw)
    ref = jax.jit(jl.prompt_mix_layer_losses)(outfeat, attn)
    jgrads = jax.jit(jax.grad(lambda f, a: sum(jl.prompt_mix_layer_losses(f, a)), (0, 1)))(
        jnp.asarray(outfeat), jnp.asarray(attn))
    f, a = _t(outfeat).requires_grad_(True), _t(attn).requires_grad_(True)
    got = tl.prompt_mix_layer_losses(f, a)
    for g, r, name in zip(got, ref, ("feat_delta", "attn_delta", "attn_norm")):
        _close(g, r, msg=name)
    sum(got).backward()
    _grads_close((f.grad, a.grad), jgrads)


def test_pooler_lookup_is_strict():
    rng = np.random.default_rng(6)
    outfeat, attn = _mix_layer_inputs(rng, 12)
    with pytest.raises(KeyError):
        jl.prompt_mix_layer_losses(outfeat, attn)
    with pytest.raises(KeyError):
        tl.prompt_mix_layer_losses(_t(outfeat), _t(attn))


def test_elastic_matching_matches():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((4, 12, 49)).astype(np.float32)
    feat = rng.standard_normal((4, 20, 49)).astype(np.float32)
    fg = (rng.random((1, 49)) > 0.6).astype(np.float32)
    ref = jl.elastic_matching_loss(q, feat, fg)
    got = tl.elastic_matching_loss(_t(q), _t(feat), _t(fg))
    for g, r in zip(got[:3], ref[:3]):
        _close(g, r)
    for g, r in zip(got[3], ref[3]):
        _close(g, r, atol=1e-6)


# distillation layers at each map size of SD at a 64x64 latent
PRESERVE_LAYERS = {22: 64, 19: 32, 16: 16, 12: 8}


def _preserve_inputs(rng, B=1, c=16, heads=2, d=8, T=12):
    outfeats, qs, scores = {}, {}, {}
    for idx, hw in PRESERVE_LAYERS.items():
        outfeats[idx] = rng.standard_normal((4 * B, hw, hw, c)).astype(np.float32)
        qs[idx] = rng.standard_normal((4 * B, heads, hw * hw, d)).astype(np.float32)
        scores[idx] = rng.standard_normal((4 * B, heads, hw * hw, T)).astype(np.float32)
    fg = np.zeros((B, 64, 64, 1), np.float32)
    fg[:, 10:40, 20:50] = 1
    subj = np.zeros((4 * B, T), np.float32)
    subj[:, 3:6] = 1
    return outfeats, qs, scores, fg, subj


def _port_preserve(outfeats, qs, scores, fg, subj, grad=False):
    tt = {k: {i: _t(v).requires_grad_(grad) for i, v in d.items()}
          for k, d in (("o", outfeats), ("q", qs), ("s", scores))}
    out = tl.comp_fg_bg_preserve_loss(tt["o"], tt["q"], tt["s"], _t(fg), _t(subj))
    return out, tt


@pytest.mark.parametrize("B", [1, 2])
def test_comp_fg_bg_preserve_matches(B):
    """Values at the four map sizes (the subject attention resized
    64->31, 32->15 and 16->7 onto the pooled grids, 8x8 unpooled), each
    block against its own mask, and the gradients of the sum of the terms
    into outfeat, q and the scores."""
    rng = np.random.default_rng(8 + B)
    outfeats, qs, scores, fg, subj = _preserve_inputs(rng, B)
    if B == 2:
        fg[1] = 0
        fg[1, 30:60, 5:25] = 1
    terms = lambda o, q, s: jl.comp_fg_bg_preserve_loss(o, q, s, jnp.asarray(fg),
                                                        jnp.asarray(subj))
    ref = jax.jit(terms)(outfeats, qs, scores)
    got, tt = _port_preserve(outfeats, qs, scores, fg, subj, grad=True)
    for g, r, name in zip(got, ref, ("map", "fg", "bg", "subj_sup", "mix_sup")):
        assert float(r) != 0, name
        _close(g, r, msg=name)
    sum(got).backward()
    jgrads = jax.jit(jax.grad(lambda o, q, s: sum(terms(o, q, s)), (0, 1, 2)))(
        outfeats, qs, scores)
    for key, jg in zip("oqs", jgrads):
        _grads_close([tt[key][i].grad for i in PRESERVE_LAYERS],
                     [jg[i] for i in PRESERVE_LAYERS])


def test_preserve_resize_stand_in_is_caught(monkeypatch):
    """A preserve battery whose subject-attention resize does not antialias
    falls outside the tolerance."""
    rng = np.random.default_rng(10)
    outfeats, qs, scores, fg, subj = _preserve_inputs(rng)
    ref = jax.jit(lambda o, q, s: jl.comp_fg_bg_preserve_loss(
        o, q, s, jnp.asarray(fg), jnp.asarray(subj)))(
        outfeats, qs, scores)
    monkeypatch.setattr(tl, "resize_aa", lambda x, oh, ow: F.interpolate(
        x.float(), (oh, ow), mode="bilinear", align_corners=False))
    got, _ = _port_preserve(outfeats, qs, scores, fg, subj)
    worst = max(abs(float(g) - float(r)) / abs(float(r)) for g, r in zip(got[3:], ref[3:]))
    assert worst > 10 * RTOL


def test_channel_layer_norm_matches_and_catches_ddof1():
    """The preserve battery's channel LayerNorm uses the population std
    (jnp's default, ddof 0), as JAX's does; a ddof-1 std (torch's default)
    falls outside the tolerance at the features."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 320, 8, 8)).astype(np.float32) * 3 + 1
    xj = jnp.asarray(x)
    ref = (xj - xj.mean(axis=1, keepdims=True)) / (xj.std(axis=1, keepdims=True) + 1e-5)
    _close(tl._channel_layer_norm(_t(x)), ref, atol=1e-6)
    xt = _t(x)
    wrong = (xt - xt.mean(1, keepdim=True)) / (xt.std(1, keepdim=True) + 1e-5)
    assert _rel(wrong, ref) > 10 * RTOL


def test_spatial_weight_catches_ddof0():
    """`convert_attn_to_spatial_weight` uses the ddof-1 std; a ddof-0 one
    falls outside the tolerance."""
    rng = np.random.default_rng(12)
    # skewed scores, so that the std (not its mean/2 floor) sets the scale
    a = (rng.random((2, 4, 256)) ** 6).astype(np.float32)
    ref = jl.convert_attn_to_spatial_weight(jnp.asarray(a), (16, 16))
    attn = _t(a).mean(1).reshape(2, 16, 16, 1)
    mean = attn.mean(dim=(1, 2), keepdim=True)
    std = attn.std(dim=(1, 2), keepdim=True, correction=0)
    w = torch.clamp_max(torch.exp(-(attn - mean) / torch.maximum(std + 0.001, mean / 2)), 1.0)
    assert _rel(w / w.mean(dim=(1, 2), keepdim=True), ref) > 10 * RTOL


@pytest.mark.parametrize("with_bg", [False, True])
def test_padding_embs_align_matches(with_bg):
    rng = np.random.default_rng(13)
    embs = rng.standard_normal((3, 2, 12, 16)).astype(np.float32)
    emb_mask = np.ones((2, 12), np.float32)
    emb_mask[0, 8:] = emb_mask[1, 6:] = 0
    subj = np.zeros((2, 12), np.float32)
    subj[:, 2:4] = 1
    bg = np.zeros((2, 12), np.float32)
    bg[:, 4:6] = 1
    ref = jl.padding_embs_align_loss(jnp.asarray(embs), jnp.asarray(emb_mask),
                                     jnp.asarray(subj), jnp.asarray(bg) if with_bg else None)
    got = tl.padding_embs_align_loss(_t(embs), _t(emb_mask), _t(subj),
                                     _t(bg) if with_bg else None)
    for g, r in zip(got, ref):
        _close(g, r)


def test_subj_comp_ortho_matches():
    rng = np.random.default_rng(14)
    T = 12
    ks = {i: rng.standard_normal((4, 2, T, 8)).astype(np.float32) for i in (7, 8, 12)}
    vs = {i: rng.standard_normal((4, 2, T, 8)).astype(np.float32) for i in (7, 8, 12)}
    sc = {i: rng.standard_normal((4, 2, 16, T)).astype(np.float32) for i in (7, 8, 12)}
    masks = [(rng.random(T) > 0.5).astype(np.float32) for _ in range(4)]
    ref = jl.subj_comp_ortho_loss(ks, vs, sc, *masks)
    got = tl.subj_comp_ortho_loss({i: _t(v) for i, v in ks.items()},
                                  {i: _t(v) for i, v in vs.items()},
                                  {i: _t(v) for i, v in sc.items()}, *map(_t, masks))
    for g, r in zip(got, ref):
        _close(g, r)


# ------------------------------------------------------- mixing, compel, x-init
@pytest.mark.parametrize("ranges", [None, (1.0, 1.0, 1.0, 0.85), (1.0, 0.8, 1.0, 0.6)])
def test_mix_static_vk_embeddings_matches(ranges):
    rng = np.random.default_rng(15)
    subj, cls = rng.standard_normal((2, 16, 2, 10, 8)).astype(np.float32)
    tok = np.zeros((2, 10), np.float32)
    tok[:, 3:6] = 1
    t_frac = np.asarray([0.85, 0.95], np.float32)
    kw = {} if ranges is None else dict(k_cls_scale_range=ranges[:2],
                                        v_cls_scale_range=ranges[2:])
    ref = jmix.mix_static_vk_embeddings(subj, cls, tok, 0.3, t_frac, **kw)
    ts, tc = _t(subj).requires_grad_(True), _t(cls).requires_grad_(True)
    got = tmix.mix_static_vk_embeddings(ts, tc, _t(tok), 0.3, _t(t_frac), **kw)
    for g, r in zip(got, ref):
        _close(g, r, atol=1e-6)
    _close(tmix.gen_layer_cls_mix_scales(16, (1.0, 0.7)),
           jmix.gen_layer_cls_mix_scales(16, (1.0, 0.7)))
    # the mixed branch's gradient is scaled by PROMPT_MIX_GRAD_SCALE
    w = rng.standard_normal(got[1].shape).astype(np.float32)
    (got[1] * _t(w)).sum().backward()
    jg = jax.grad(lambda s, c: (jmix.mix_static_vk_embeddings(
        s, c, tok, 0.3, t_frac, **kw)[1] * w).sum(), (0, 1))(subj, cls)
    _grads_close((ts.grad, tc.grad), jg)


@pytest.mark.parametrize("level,mask", [(0.0, None), (2.0, None), (1.5, [0, 0, 1, 1])])
def test_apply_compel_cfg_matches(level, mask):
    rng = np.random.default_rng(16)
    ctx = rng.standard_normal((16, 4, 10, 8)).astype(np.float32)
    empty = rng.standard_normal((10, 8)).astype(np.float32)
    bm = None if mask is None else np.asarray(mask, np.float32)
    ref = jcompel.apply_compel_cfg(ctx, empty, level, batch_mask=bm)
    got = tcompel.apply_compel_cfg(_t(ctx), _t(empty), level,
                                   batch_mask=None if bm is None else _t(bm))
    _close(got, ref, atol=1e-6)
    if level == 0:
        c = _t(ctx)
        assert tcompel.apply_compel_cfg(c, _t(empty), 0.0) is c


@pytest.mark.parametrize("prob,levels", [(0.5, (2.0, 2.0)), (0.7, (1.0, 3.0)), (0.0, 2.0),
                                         (1.0, 2.5)])
def test_sample_compel_cfg_draws_match(prob, levels):
    jr, tr = np.random.default_rng(17), np.random.default_rng(17)
    for _ in range(20):
        jl_, jm = jcompel.sample_compel_cfg(jr, prob, levels, 4)
        tl_, tm = tcompel.sample_compel_cfg(tr, prob, levels, 4)
        assert tl_ == jl_
        assert (tm is None) == (jm is None)
        if tm is not None:
            np.testing.assert_array_equal(tm, np.asarray(jm))
    assert jr.random() == tr.random()  # the same draws were consumed


@pytest.mark.parametrize("fg_box,pct", [((4, 12, 3, 11), 0.1), ((1, 15, 1, 15), 0.8),
                                        ((6, 9, 6, 9), 0.5)])
def test_init_x_with_fg_matches(fg_box, pct):
    """Fg-initialized x_start and its mask from one seed, both branches of
    the fg share (over and under 10% of the image)."""
    rng = np.random.default_rng(18)
    x = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    fg = np.zeros((1, 16, 16, 1), np.float32)
    fg[:, fg_box[0]:fg_box[1], fg_box[2]:fg_box[3]] = 1
    jr, tr = np.random.default_rng(19), np.random.default_rng(19)
    jx_, jfg = jx.init_x_with_fg_from_training_image(jr, x, fg, pct)
    tx_, tfg = tx.init_x_with_fg_from_training_image(tr, x, fg, pct)
    np.testing.assert_array_equal(tfg, jfg)
    np.testing.assert_allclose(tx_, jx_, rtol=0, atol=1e-6)
    assert jr.random() == tr.random()
    assert tx.rand_annealed(tr, pct, 1.0, (0.1, 0.4)) == jx.rand_annealed(jr, pct, 1.0,
                                                                           (0.1, 0.4))


def test_resize_bilinear_exact_scale_matches():
    rng = np.random.default_rng(20)
    x = rng.standard_normal((1, 16, 16, 5)).astype(np.float32)
    for oh, scale in ((11, 0.73), (13, None)):
        np.testing.assert_allclose(tx._resize_bilinear_nhwc(x, oh, oh, scale=scale),
                                   jx._resize_bilinear_nhwc(x, oh, oh, scale=scale),
                                   rtol=0, atol=1e-6)


def test_cached_inits_roundtrip():
    c = CachedInits()
    c.put("s", np.ones((1, 2)), np.asarray([500]), prompts=["a"])
    assert "s" in c and c.peek("s")["prompts"] == ["a"]
    assert c.pop("s")["t"].tolist() == [500] and "s" not in c and c.pop("s") is None


# ------------------------------------------------------------- the loss_fn
COMPOS_PROMPTS = ["a photo of a z , , , , , , , , with background y , , ,",
                  "a photo of a z , , , , , , , , with background y , , , riding a bike",
                  "a photo of a person , , , , , , , , with background y , , ,",
                  "a photo of a person , , , , , , , , with background y , , , riding a bike"]
STEP_KW = dict(prompt_delta_weight=0.5, mix_prompt_distill_weight=0.5, fg_bg_weight=0.5,
               comp_fg_bg_preserve_weight=0.5, xlayer_weight=0.5, do_zero_shot=False,
               bg_placeholders=frozenset({"y"}))
REG_KW = dict(padding_embs_align_weight=0.5, subj_comp_ortho_weight=0.5)


def _compos_batch(jp, rng, compel=True):
    """A JAX ComposBatch and the port's from the same numpy arrays: an
    fg-initialized x_start, compel level 2 on the mix rows only, a
    preserve scale of 0.5 and the fg-init class-mix ranges."""
    ids = jp.tokenizer(COMPOS_PROMPTS)
    slots = jp.embedding_manager.build_slot_maps(ids)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    fg = np.zeros((1, 16, 16, 1), np.float32)
    fg[0, 2:14, 3:12] = 1
    lat, fg = tx.init_x_with_fg_from_training_image(np.random.default_rng(5), lat, fg, 0.3)
    noise = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    t = np.asarray([850])
    level, mask = (2.0, np.asarray([0, 0, 1, 1], np.float32)) if compel else (0.0, None)
    ranges = np.asarray([1.0, 1.0, 1.0, 0.85], np.float32)
    common = dict(t_frac=t / 1000, training_percent=np.float32(0.3), compel_level=level,
                  preserve_loss_scale=0.5)
    j = jts.ComposBatch(
        token_ids=jnp.asarray(ids), slot_maps={k: jnp.asarray(v) for k, v in slots.items()},
        subj_slot_map=jnp.asarray(slots["z"]), latents=jnp.asarray(lat),
        fg_mask=jnp.asarray(fg), timesteps=jnp.asarray(t, jnp.int32),
        noise=jnp.asarray(noise), compel_batch_mask=None if mask is None else jnp.asarray(mask),
        cls_mix_ranges=jnp.asarray(ranges),
        **{k: jnp.asarray(v, jnp.float32) if k != "compel_level" else v
           for k, v in common.items()})
    p = tts.ComposBatch(
        token_ids=ids, slot_maps=slots, subj_slot_map=slots["z"], latents=_t(lat),
        fg_mask=_t(fg), timesteps=torch.tensor(t, dtype=torch.int32), noise=_t(noise),
        t_frac=_t(t / 1000), training_percent=float(common["training_percent"]),
        compel_level=level, compel_batch_mask=None if mask is None else _t(mask),
        cls_mix_ranges=tuple(float(v) for v in ranges), preserve_loss_scale=0.5)
    return j, p


def _jax_compos_value_and_grad(jp, kw, with_compel):
    """`jax.value_and_grad` of the JAX compos loss: its step's loss_fn body
    (embed, static embeddings, patch) around `_make_compos_loss_core`."""
    core = jts._make_compos_loss_core(
        jp.clip, jp.unet, jp.base_sched, (0.5, 0.5), kw["prompt_delta_weight"],
        kw["mix_prompt_distill_weight"], kw["fg_bg_weight"], kw["comp_fg_bg_preserve_weight"],
        kw["xlayer_weight"], kw["do_zero_shot"], kw["bg_placeholders"],
        padding_embs_align_weight=kw.get("padding_embs_align_weight", 0.0),
        subj_comp_ortho_weight=kw.get("subj_comp_ortho_weight", 0.0))
    fz = {"clip": jp.clip_params, "unet": jp.unet_params}
    if with_compel:
        fz["empty_ctx"] = jp.encode_negative("", 1)[0]

    def loss_fn(embedders, batch):
        embedded = jp.clip.apply({"params": fz["clip"]}, batch.token_ids,
                                 method=JCLIPTextEncoder.embed_tokens)
        subj = {s: j_static(p) for s, p in embedders.items()}
        return core(JEM.patch_prompt_embeddings(embedded, batch.slot_maps, subj), batch, fz)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("regs", [False, True], ids=["shipped", "disabled_regs_on"])
def test_compos_loss_fn_matches(pipes, regs):
    jp, tp = pipes
    kw = dict(STEP_KW, **(REG_KW if regs else {}))
    jb, tb = _compos_batch(jp, np.random.default_rng(21))
    (_, jmetrics), jgrads = _jax_compos_value_and_grad(jp, kw, True)(
        jp.embedding_manager.embedders, jb)
    captured = {}
    orig = tp.unet.forward

    def spy(*a, **k):
        out = orig(*a, **k)
        captured.update(out[1])
        return out

    step = tts.make_compos_distill_step(tp.clip, tp.unet, tp.base_sched, None,
                                        empty_ctx=tp.encode_negative("", 1)[0, 0].clone(), **kw)
    emb = _port_embedders(tp)
    tp.unet.forward = spy
    try:
        loss, metrics = step.loss_fn(emb, tb)
    finally:
        del tp.unet.forward
    loss.backward()
    assert sorted(captured) == [7, 8]  # the tiny UNet's distillation layers, 16x16
    assert {"q", "attnscore", "outfeat"} <= set(captured[7])
    assert set(metrics) == set(jmetrics)
    if regs:
        assert {"padding_embs_align", "subj_comp_ortho_k", "subj_comp_ortho_v"} <= set(metrics)
    for k in sorted(metrics):
        assert abs(float(jmetrics[k])) > 0, f"metric {k} is zero"
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    _assert_grads_close(emb, jgrads)


def test_compos_loss_fn_without_compel_matches(pipes):
    """No empty context (compel off, the trainer's default): the step's
    contexts go to the UNet as mixed."""
    jp, tp = pipes
    jb, tb = _compos_batch(jp, np.random.default_rng(22), compel=False)
    (_, jmetrics), jgrads = _jax_compos_value_and_grad(jp, STEP_KW, False)(
        jp.embedding_manager.embedders, jb)
    step = tts.make_compos_distill_step(tp.clip, tp.unet, tp.base_sched, None, **STEP_KW)
    emb = _port_embedders(tp)
    loss, metrics = step.loss_fn(emb, tb)
    loss.backward()
    for k in sorted(jmetrics):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    _assert_grads_close(emb, jgrads)


# ---------------------------------------------------------------- trainers
PLAN_KW = dict(composition_regs_iter_gap=3, do_zero_shot=False,
               prompt_emb_delta_reg_weight=2e-4, mix_prompt_distill_weight=2e-4,
               arc2face_distill_iter_prob=0.0)
COMPOS_FIELDS = ("token_ids", "subj_slot_map", "fg_mask", "timesteps", "noise", "t_frac",
                 "cls_mix_ranges", "preserve_loss_scale")


def test_trainer_builds_the_same_compos_batches(pipes, subject_dir, tmp_path):
    """A gap-3 fit(7) in both trainers, each handed recording steps: the
    same recon batches (as `test_torch_train_step` checks) and the same
    ComposBatch arrays at steps 0, 3 and 6, with compel on. A CachedInits
    entry seeded into both makes step 0 a reuse-init iteration (cached
    x_start, t, fg mask and prompts, mid-range t); 3 and 6 are fresh."""
    jp, tp = pipes
    cfg = dict(batch_size=2, max_steps=20, seed=4, log_every_steps=1000, ckpt_every_steps=1000,
               apply_compel_cfg_prob=0.6, compel_cfg_weight_level_range=(1.0, 3.0))
    jtr = JTrainer(jp, JDataset([JSpec("s", subject_dir)], size=32, seed=0),
                   JTrainerConfig(logdir=str(tmp_path / "j"), **cfg), JPlanConfig(**PLAN_KW))
    ttr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                  TrainerConfig(logdir=str(tmp_path / "t"), **cfg), IterPlanConfig(**PLAN_KW))
    rng = np.random.default_rng(23)
    x = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    fgc = np.zeros((1, 4, 4, 1), np.float32)
    fgc[0, 1:3, 1:3] = 1
    prompts = ["a z , , , , , , , , with background y , , ,",
               "a z , , , , , , , , with background y , , , in the rain",
               "a person , , , , , , , , with background y , , ,",
               "a person , , , , , , , , with background y , , , in the rain"]
    entry = dict(fg_mask=fgc, prompts=prompts, use_background_token=True,
                 comp_init_fg_from_training_image=True, use_wds_comp=False)
    jtr.cached_inits, ttr.cached_inits = JCachedInits(), CachedInits()
    jtr.cached_inits.put("s", x, np.asarray([930]), **entry)
    ttr.cached_inits.put("s", x, np.asarray([930]), **entry)
    jrec, trec = [], []
    record_j = lambda *a: (lambda e, o, b, f=None: (jrec.append(b) or (e, o, {})))
    record_t = lambda *a: (lambda e, b: (trec.append(b) or {}))
    jtr._get_recon_step = jtr._get_compos_step = record_j
    ttr._get_recon_step = ttr._get_compos_step = record_t
    jtr.fit(7)
    ttr.fit(7)
    ttr.close()
    assert [type(b).__name__ for b in trec] == [type(b).__name__ for b in jrec]
    compos = [(j, t) for j, t in zip(jrec, trec) if isinstance(t, tts.ComposBatch)]
    assert len(compos) == 3 and len(trec) == 7
    for i, (jb, tb) in enumerate(compos):
        np.testing.assert_allclose(tb.latents.numpy(), np.asarray(jb.latents), atol=1e-4)
        for name in COMPOS_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(tb, name), np.float32),
                                          np.asarray(getattr(jb, name), np.float32),
                                          err_msg=f"compos {i}: {name}")
        assert tb.training_percent == pytest.approx(float(jb.training_percent), rel=1e-7)
        # JAX hands a mask of ones to its jitted step where the draw gave
        # none; the port keeps None, which applies to every row alike
        mask = np.ones(4) if tb.compel_batch_mask is None else tb.compel_batch_mask.numpy()
        np.testing.assert_array_equal(mask, np.asarray(jb.compel_batch_mask))
        assert tb.compel_level == pytest.approx(float(jb.compel_level), rel=0, abs=0)
        assert sorted(tb.slot_maps) == sorted(jb.slot_maps)
        for k in tb.slot_maps:
            np.testing.assert_array_equal(tb.slot_maps[k], np.asarray(jb.slot_maps[k]))
        if jb.emb_noise_std is None:
            assert tb.emb_noise_std is None
        else:
            assert tb.emb_noise_std == pytest.approx(float(jb.emb_noise_std))
            assert tb.emb_noise_seed == int(np.asarray(jb.emb_noise_key)[-1])
    reuse = compos[0][1]
    np.testing.assert_array_equal(reuse.latents.numpy(), x)
    assert reuse.preserve_loss_scale == 0.25 and reuse.timesteps.item() <= 930 - 150
    assert ttr.cached_inits.peek("s") is None
    assert 0.5 in {b.preserve_loss_scale for _, b in compos[1:]}  # a fresh fg-init
    assert any(b.compel_level > 0 for _, b in compos)
    for jb, tb in zip(jrec, trec):
        if isinstance(tb, tts.ReconBatch):
            for name in ("token_ids", "fg_mask", "timesteps", "noise", "img_mask"):
                np.testing.assert_array_equal(np.asarray(getattr(tb, name)),
                                              np.asarray(getattr(jb, name)), err_msg=name)


def test_cache_teacher_recon_feeds_the_next_compos_iteration(pipes, subject_dir, tmp_path):
    """`_cache_teacher_recon` stores a block's reconstruction with its
    prompts and flags; the next compos batch reuses it at mid-range t."""
    _, tp = pipes
    ttr = Trainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32, seed=0),
                  TrainerConfig(logdir=str(tmp_path), batch_size=1, log_every_steps=1000),
                  IterPlanConfig(**PLAN_KW))
    ttr.cached_inits = CachedInits()
    from adaface_tpu_torch.training.iter_plan import COMPOS_DISTILL, IterPlan

    plan = IterPlan(iter_type=COMPOS_DISTILL, comp_init_fg_from_training_image=True)
    prompts = ["a z , , , , , , , ,", "a z , , , , , , , , in the rain",
               "a person , , , , , , , ,", "a person , , , , , , , , in the rain"]
    x = torch.randn(1, 4, 4, 4)
    ttr._cache_teacher_recon({"subject_name": "s"}, x, np.asarray([800]),
                             np.ones((1, 4, 4, 1), np.float32), plan, prompts)
    batch = ttr.build_compos_batch(IterPlan(iter_type=COMPOS_DISTILL))
    ttr.close()
    np.testing.assert_array_equal(batch.latents.numpy(), x.numpy())
    np.testing.assert_array_equal(batch.token_ids, tp.tokenizer(prompts))
    assert batch.preserve_loss_scale == 0.25 and 400 <= batch.timesteps.item() <= 650
