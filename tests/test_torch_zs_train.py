"""Port parity of zero-shot training, fp32 on the CPU.

A tiny pipeline (CLIP 64 wide over the full tokenizer vocabulary with 77
positions, a two-level UNet at 16x16 latents), a second UNet as the Arc2Face
teacher, a two-layer Arc2Face text encoder, and the two generators of
`test_torch_zero_shot.py` (fg face branch K 16 on that encoder's config, bg
K 4 on 48-wide image features), all carried across by
`interop/from_jax.py`; the port's generators are loaded without `.eval()`
and the batches carry no dropout seed (JAX: no dropout key).

- the zs recon step (with and without the bg token), the zs compos step
  (the frozen anchor a perturbed copy, so the blend counts) and the zs
  Arc2Face step (S 1 with a fg mask, S 3 on a random face, S 3 at batch 3
  where only the trailing 2 steps count): the loss and every metric
  against JAX's own step at rtol 1e-5, every generator gradient at 1e-4
  of its leaf's largest value (JAX's gradients captured by an optax
  transformation that returns them as its state);
- one optimizer update (clip + Prodigy) of the zs recon step;
- the trainers: from one seed both `ZeroShotTrainer`s build the same
  batches over a plan mixing recon, compos and Arc2Face (S 1 and S > 1,
  a random face, noised real ids): ids, slot maps, timesteps, noises,
  relative ts, masks and identity embeddings bit for bit, features and
  latents within 1e-4, `_noise_id_embs` bit for bit;
- resume: a run resumed from its step-2 checkpoint draws the batches of
  the uninterrupted run and ends with the same generators, bit for bit.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaface_tpu.data.personalized import PersonalizedDataset as JDataset
from adaface_tpu.data.personalized import SubjectSpec as JSpec
from adaface_tpu.data.tokenizer import HashTokenizer as JTok
from adaface_tpu.models import clip_text as jct
from adaface_tpu.models import clip_vision as jcv
from adaface_tpu.models.unet import UNetConfig as JUNetConfig
from adaface_tpu.models.vae import VAEConfig as JVAEConfig
from adaface_tpu.personalization import arc2face as ja2f
from adaface_tpu.personalization.subj_basis_generator import SubjBasisGenerator as JGen
from adaface_tpu.personalization.zero_shot import ZeroShotFeatureExtractor as JExtractor
from adaface_tpu.pipeline import StableDiffusionPipeline as JPipeline
from adaface_tpu.training import train_step as jts
from adaface_tpu.training.iter_plan import IterPlanConfig as JPlanConfig
from adaface_tpu.training.prodigy import prodigy as j_prodigy
from adaface_tpu.training.trainer import TrainerConfig as JTrainerConfig
from adaface_tpu.training.zs_trainer import ZeroShotTrainer as JZSTrainer

from adaface_tpu_torch.data.personalized import PersonalizedDataset, SubjectSpec
from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.models import clip_text as tct
from adaface_tpu_torch.models import clip_vision as tcv
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from adaface_tpu_torch.personalization import arc2face as ta2f
from adaface_tpu_torch.personalization.subj_basis_generator import SubjBasisGenerator
from adaface_tpu_torch.personalization.zero_shot import ZeroShotFeatureExtractor
from adaface_tpu_torch.pipeline import StableDiffusionPipeline
from adaface_tpu_torch.training import train_step as tts
from adaface_tpu_torch.training.iter_plan import IterPlanConfig
from adaface_tpu_torch.training.prodigy import AccumulatedClipped, Prodigy
from adaface_tpu_torch.training.trainer import TrainerConfig
from adaface_tpu_torch.training.zs_trainer import ZeroShotTrainer

from test_torch_train_step import subject_dir  # noqa: F401

torch.set_num_threads(2)

D, VD, T = 64, 48, 77
RTOL, GRAD_TOL = 1e-5, 1e-4
UNET_KW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               attention_levels=(0, 1), num_heads=4, context_dim=D,
               use_flash_attention=False)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)
TXT_KW = dict(vocab_size=49408, hidden_size=D, num_layers=2, num_heads=4,
              intermediate_size=128, max_position_embeddings=T)
Z_SLOTS, Y_SLOTS = " ," * 15, " , , ,"
PROMPTS = [f"a photo of a z{Z_SLOTS} with background y{Y_SLOTS}",
           f"the close-up z{Z_SLOTS} in a garden y{Y_SLOTS}",
           f"a portrait of z{Z_SLOTS}"]
DELTA_EXTRA = ["riding a bike", "in the snow", "on a beach"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gen_kw(bg):
    if bg:
        return dict(placeholder_is_bg=True, num_out_layers=16, num_out_embs_per_layer=4,
                    output_dim=D, image_embedding_dim=VD, num_heads=4, bg_num_id_vecs=5)
    return dict(placeholder_is_bg=False, num_out_layers=16, num_out_embs_per_layer=16,
                output_dim=D, pad_token_id=49407)


def _load(m, sd):
    m.load_state_dict(sd, strict=True)
    return m


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.2 * rng.standard_normal(a.shape))).astype(a.dtype), tree)


@pytest.fixture(scope="module")
def zs():
    jtok, ttok = JTok(), HashTokenizer()
    clip_kw = dict(vocab_size=jtok.vocab_size, hidden_size=D, num_layers=2, num_heads=4,
                   intermediate_size=128, max_position_embeddings=T, num_extra_tokens=8)
    jp = JPipeline.from_random(jax.random.PRNGKey(0), jtok, JUNetConfig(**UNET_KW),
                               JVAEConfig(**VAE_KW), jct.CLIPTextConfig(**clip_kw))
    teacher_params = _np_tree(jp.unet.init(
        jax.random.PRNGKey(9), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 1, T, D)))["params"])
    tp = StableDiffusionPipeline(
        ttok,
        _load(tct.CLIPTextEncoder(tct.CLIPTextConfig(**clip_kw)),
              from_jax.clip_state_dict_from_jax(_np_tree(jp.clip_params))),
        _load(UNetModel(UNetConfig(**UNET_KW)),
              from_jax.unet_state_dict_from_jax(_np_tree(jp.unet_params))),
        _load(AutoencoderKL(VAEConfig(**VAE_KW)),
              from_jax.vae_state_dict_from_jax(_np_tree(jp.vae_params))))
    teacher = _load(UNetModel(UNetConfig(**UNET_KW)),
                    from_jax.unet_state_dict_from_jax(teacher_params)).eval()

    txt_cfg = jct.CLIPTextConfig(**TXT_KW)
    arc_params = _np_tree(jct.CLIPTextEncoder(txt_cfg).init(
        jax.random.PRNGKey(1), input_ids=jnp.zeros((1, T), jnp.int32))["params"])
    arc = _load(tct.CLIPTextEncoder(tct.CLIPTextConfig(**TXT_KW)),
                from_jax.clip_state_dict_from_jax(arc_params))
    inv_ids = jtok([ja2f.INVERSE_TEMPLATE], max_length=T)
    fwd_ids = jtok([ja2f.FORWARD_TEMPLATE], max_length=T)
    arc_tid = int(jtok.encode("id")[0])
    jgens = {"z": JGen(**_gen_kw(False), proj_cfg=txt_cfg), "y": JGen(**_gen_kw(True))}
    gparams = {
        "z": _np_tree(jgens["z"].init(jax.random.PRNGKey(2), None, None, jnp.zeros((1, 16, D)),
                                      inverse_template_ids=jnp.asarray(inv_ids))["params"]),
        "y": _np_tree(jgens["y"].init(jax.random.PRNGKey(3), jnp.zeros((1, 5, VD)), None,
                                      None)["params"])}
    # the bg generator's output is small next to the fg one's at init;
    # scale its latent queries up so that its gradients are not noise
    gparams["y"]["latent_queries"] = gparams["y"]["latent_queries"] * 30.0

    def port_gens(trees):
        return {"z": from_jax.load_subj_basis_generator_from_jax(
                    SubjBasisGenerator(**_gen_kw(False), proj_cfg=tct.CLIPTextConfig(**TXT_KW)),
                    trees["z"]),
                "y": from_jax.load_subj_basis_generator_from_jax(
                    SubjBasisGenerator(**_gen_kw(True)), trees["y"])}

    gens = port_gens(gparams)
    for s, bg in (("z", False), ("y", True)):
        tid = jtok.add_placeholder(s)
        assert ttok.add_placeholder(s) == tid
        jp.embedding_manager.add_placeholder(s, token_id=tid, num_vectors=4 if bg else 16,
                                             is_background=bg, emb_dim=D)
        tp.embedding_manager.add_zero_shot_placeholder(s, tid, gens[s], is_background=bg)
    templates = tts.ZeroShotTemplates(fwd_ids, inv_ids, arc_tid)
    return dict(jp=jp, tp=tp, teacher_params=teacher_params, teacher=teacher,
                arc_params=arc_params, arc=arc, jgens=jgens, gparams=gparams,
                port_gens=port_gens, templates=templates, txt_cfg=txt_cfg)


def _jax_kw(zs):
    jp, t = zs["jp"], zs["templates"]
    return dict(generators=zs["jgens"], bg_placeholders=frozenset({"y"}),
                arc2face_encoder=jct.CLIPTextEncoder(zs["txt_cfg"]),
                arc2face_params=zs["arc_params"],
                forward_template_ids=jnp.asarray(t.forward_ids),
                inverse_template_ids=jnp.asarray(t.inverse_ids),
                arcface_token_id=t.arcface_token_id)


def _port_kw(zs):
    return dict(bg_placeholders=frozenset({"y"}), arc2face_encoder=zs["arc"],
                templates=zs["templates"])


def _capture_grads():
    """An optax transformation whose state after `update` is the gradient
    itself (and whose update is zero): JAX's real step, its gradients read
    exactly."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_step(step, zs, batch, frozen):
    gp = jax.tree_util.tree_map(jnp.asarray, zs["gparams"])
    _, grads, metrics = jax.jit(step)(gp, jax.tree_util.tree_map(jnp.zeros_like, gp), batch,
                                      frozen)
    return metrics, _np_tree(grads)


def _check(metrics, loss, jmetrics, jgrads, gens, moving=("y", "z")):
    loss.backward()
    assert set(metrics) == set(jmetrics), (sorted(metrics), sorted(jmetrics))
    for k in sorted(metrics):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    for s, gen in gens.items():
        want = from_jax.state_dict_from_jax(jgrads[s])
        got = dict(gen.named_parameters())
        assert set(want) <= set(got)
        top = max(float(r.abs().max()) for r in want.values())
        for name, ref in want.items():
            ref = ref.numpy()
            g = got[name].grad
            g = np.zeros_like(ref) if g is None else g.numpy()
            scale = np.abs(ref).max()
            if scale < 1e-6 * top:
                # a gradient that is zero but for round-off (a key bias
                # under softmax, the fg pos_embs): near zero on both sides
                assert np.abs(g).max() < 1e-6 * top, f"{s}.{name}"
                continue
            np.testing.assert_allclose(g, ref, atol=GRAD_TOL * scale, rtol=0,
                                       err_msg=f"{s}.{name}")
    nonzero = [(s, n) for s in jgrads for n, r in from_jax.state_dict_from_jax(jgrads[s]).items()
               if float(r.abs().max()) > 0]
    assert {s for s, _ in nonzero} == set(moving)


def _inputs(rng, b, lat=16):
    return dict(lat=rng.standard_normal((b, lat, lat, 4)).astype(np.float32),
                noise=rng.standard_normal((b, lat, lat, 4)).astype(np.float32),
                clip_fg=rng.standard_normal((b, 5, VD)).astype(np.float32),
                clip_bg=rng.standard_normal((b, 5, VD)).astype(np.float32),
                ids=(lambda e: e / np.linalg.norm(e, axis=-1, keepdims=True))(
                    rng.standard_normal((b, 512)).astype(np.float32)))


def _masks(b, lat=16):
    fg = np.zeros((b, lat, lat, 1), np.float32)
    fg[:, 3:12, 4:13] = 1
    fg[-1, 5:15, 2:9] = 1
    img = np.zeros((b, lat, lat, 1), np.float32)
    img[:, 1:15, 2:16] = 1
    return fg, img


tt = lambda a: torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- zs recon
RECON_KW = dict(complem_weight=0.5, xlayer_weight=0.5, prompt_delta_weight=0.5)


def _recon_batches(zs, use_bg, seed=0):
    jp = zs["jp"]
    rng = np.random.default_rng(seed)
    b = 2
    prompts = PROMPTS[:2] if use_bg else [PROMPTS[2], PROMPTS[2].replace("portrait", "photo")]
    ids = jp.tokenizer(prompts)
    slots = jp.embedding_manager.build_slot_maps(ids)
    cls = [p.replace("z" + Z_SLOTS, "person" + Z_SLOTS) for p in prompts]
    delta = prompts + [f"{p} {e}" for p, e in zip(prompts, DELTA_EXTRA)] + cls + \
        [f"{p} {e}" for p, e in zip(cls, DELTA_EXTRA)]
    dids = jp.tokenizer(delta)
    dslots = jp.embedding_manager.build_slot_maps(dids)
    x = _inputs(rng, b)
    fg, img = _masks(b)
    have = np.array([1.0, 0.0], np.float32)
    t = np.array([501, 120], np.int32)
    j = jts.ZeroShotReconBatch(
        latents=jnp.asarray(x["lat"]), token_ids=jnp.asarray(ids),
        slot_maps={k: jnp.asarray(v) for k, v in slots.items()}, fg_mask=jnp.asarray(fg),
        timesteps=jnp.asarray(t), noise=jnp.asarray(x["noise"]),
        clip_fg=jnp.asarray(x["clip_fg"]), clip_bg=jnp.asarray(x["clip_bg"]),
        id_embs=jnp.asarray(x["ids"]), img_mask=jnp.asarray(img),
        have_fg_mask=jnp.asarray(have), delta_token_ids=jnp.asarray(dids),
        delta_slot_maps={k: jnp.asarray(v) for k, v in dslots.items()})
    p = tts.ZeroShotReconBatch(
        latents=tt(x["lat"]), token_ids=ids, slot_maps=slots, fg_mask=tt(fg),
        timesteps=torch.tensor(t), noise=tt(x["noise"]), clip_fg=tt(x["clip_fg"]),
        clip_bg=tt(x["clip_bg"]), id_embs=tt(x["ids"]), img_mask=tt(img),
        have_fg_mask=tt(have), delta_token_ids=dids, delta_slot_maps=dslots)
    return j, p


@pytest.mark.parametrize("use_bg", [True, False])
def test_zs_recon_step_matches_jax(zs, use_bg):
    jp, tp = zs["jp"], zs["tp"]
    jb, pb = _recon_batches(zs, use_bg)
    bg_weight = 0.1 if use_bg else 0.0
    jstep = jts.make_zero_shot_recon_step(
        jp.clip, jp.clip_params, jp.unet, jp.unet_params, jp.base_sched, _capture_grads(),
        **_jax_kw(zs), bg_weight=bg_weight, use_bg_token=use_bg, **RECON_KW)
    jmetrics, jgrads = _jax_step(jstep, zs, jb, {"clip": jp.clip_params,
                                                 "unet": jp.unet_params,
                                                 "arc": zs["arc_params"]})
    gens = zs["port_gens"](zs["gparams"])
    step = tts.make_zero_shot_recon_step(tp.clip, tp.unet, tp.base_sched, None, **_port_kw(zs),
                                         bg_weight=bg_weight, use_bg_token=use_bg, **RECON_KW)
    loss, metrics = step.loss_fn(gens, pb)
    assert ("fg_bg_complem" in metrics) == use_bg and "prompt_delta" in metrics
    # without the bg token the prompt holds no bg slot: the bg generator idles
    _check(metrics, loss, jmetrics, jgrads, gens, ("y", "z") if use_bg else ("z",))


def test_zs_recon_update_matches_jax(zs):
    """One update through clip 0.5 + Prodigy (d_coef 10): the generators'
    parameters after it."""
    jp, tp = zs["jp"], zs["tp"]
    jb, pb = _recon_batches(zs, True, seed=1)
    kw = dict(bg_weight=0.1, use_bg_token=True, **RECON_KW)
    opt = optax.chain(optax.clip_by_global_norm(0.5), j_prodigy(learning_rate=1.0, d_coef=10.0))
    jstep = jts.make_zero_shot_recon_step(jp.clip, jp.clip_params, jp.unet, jp.unet_params,
                                          jp.base_sched, opt, **_jax_kw(zs), **kw)
    gp = jax.tree_util.tree_map(jnp.asarray, zs["gparams"])
    new, _, _ = jax.jit(jstep)(gp, opt.init(gp), jb, {"clip": jp.clip_params,
                                                       "unet": jp.unet_params,
                                                       "arc": zs["arc_params"]})
    gens = zs["port_gens"](zs["gparams"])
    params = [p.requires_grad_(True) for s in sorted(gens)
              for p in gens[s].face_trainable_parameters()]
    chain = AccumulatedClipped(Prodigy(params, lr=1.0, d_coef=10.0), 0.5, every_k=1)
    step = tts.make_zero_shot_recon_step(tp.clip, tp.unet, tp.base_sched, chain, **_port_kw(zs),
                                         **kw)
    step(gens, pb)
    assert chain.inner.step_count == 1
    moved = 0.0
    for s, gen in gens.items():
        want = from_jax.state_dict_from_jax(_np_tree(new[s]))
        before = from_jax.state_dict_from_jax(zs["gparams"][s])
        got = dict(gen.named_parameters())
        for name, ref in want.items():
            delta = (ref - before[name]).abs().max()
            moved = max(moved, float(delta))
            np.testing.assert_allclose(got[name].detach().numpy(), ref.numpy(),
                                       atol=1e-4 * max(float(delta), 1e-12) + 1e-7, rtol=0,
                                       err_msg=f"{s}.{name}")
    assert moved > 0


# ---------------------------------------------------------------- zs compos
def _compos_batches(zs):
    jp = zs["jp"]
    rng = np.random.default_rng(4)
    base = f"a photo of a z{Z_SLOTS} with background y{Y_SLOTS}"
    cls = f"a photo of a person{Z_SLOTS} with background y{Y_SLOTS}"
    prompts = [base, base + " riding a bike", cls, cls + " riding a bike"]
    ids = jp.tokenizer(prompts)
    slots = jp.embedding_manager.build_slot_maps(ids)
    x = _inputs(rng, 1)
    fg, _ = _masks(1)
    t = np.array([880], np.int32)
    common = dict(t_frac=t / 1000.0, training_percent=0.3,
                  cls_mix_ranges=(1.0, 0.8, 1.0, 0.6), preserve_loss_scale=0.5)
    j = jts.ZeroShotComposBatch(
        token_ids=jnp.asarray(ids), slot_maps={k: jnp.asarray(v) for k, v in slots.items()},
        subj_slot_map=jnp.asarray(slots["z"]), latents=jnp.asarray(x["lat"]),
        fg_mask=jnp.asarray(fg), timesteps=jnp.asarray(t), noise=jnp.asarray(x["noise"]),
        clip_fg=jnp.asarray(x["clip_fg"]), clip_bg=jnp.asarray(x["clip_bg"]),
        id_embs=jnp.asarray(x["ids"]),
        **{**common, "t_frac": jnp.asarray(common["t_frac"], jnp.float32),
           "training_percent": jnp.asarray(0.3, jnp.float32),
           "cls_mix_ranges": jnp.asarray(common["cls_mix_ranges"], jnp.float32),
           "preserve_loss_scale": jnp.asarray(0.5, jnp.float32)})
    p = tts.ZeroShotComposBatch(
        token_ids=ids, slot_maps=slots, subj_slot_map=slots["z"], latents=tt(x["lat"]),
        fg_mask=tt(fg), timesteps=torch.tensor(t), noise=tt(x["noise"]),
        clip_fg=tt(x["clip_fg"]), clip_bg=tt(x["clip_bg"]), id_embs=tt(x["ids"]),
        **{**common, "t_frac": torch.tensor(t / 1000.0, dtype=torch.float32)})
    return j, p


def test_zs_compos_step_matches_jax(zs):
    jp, tp = zs["jp"], zs["tp"]
    jb, pb = _compos_batches(zs)
    gen0 = {s: _perturbed(v, 5 + i) for i, (s, v) in enumerate(sorted(zs["gparams"].items()))}
    kw = dict(prompt_delta_weight=0.5, mix_prompt_distill_weight=0.5, xlayer_weight=0.5)
    jstep = jts.make_zero_shot_compos_step(jp.clip, jp.clip_params, jp.unet, jp.unet_params,
                                           jp.base_sched, _capture_grads(), **_jax_kw(zs), **kw)
    jmetrics, jgrads = _jax_step(jstep, zs, jb, {
        "clip": jp.clip_params, "unet": jp.unet_params, "arc": zs["arc_params"],
        "gen0": jax.tree_util.tree_map(jnp.asarray, gen0)})
    gens = zs["port_gens"](zs["gparams"])
    frozen = {s: g.requires_grad_(False) for s, g in zs["port_gens"](gen0).items()}
    step = tts.make_zero_shot_compos_step(tp.clip, tp.unet, tp.base_sched, None, frozen,
                                          **_port_kw(zs), **kw)
    loss, metrics = step.loss_fn(gens, pb)
    assert float(metrics["comp_fg_bg_preserve"].detach()) > 0
    assert float(metrics["feat_align"].detach()) > 0
    _check(metrics, loss, jmetrics, jgrads, gens)


# -------------------------------------------------------------- zs arc2face
def _a2f_batches(zs, S, b, rand_face, seed):
    jp = zs["jp"]
    rng = np.random.default_rng(seed)
    ids = jp.tokenizer([PROMPTS[i % 3] for i in range(b)])
    slots = jp.embedding_manager.build_slot_maps(ids)
    x = _inputs(rng, b)
    noises = rng.standard_normal((S, b, 16, 16, 4)).astype(np.float32)
    rel = rng.uniform(size=(max(S - 1, 1), b)).astype(np.float32)
    t = rng.integers(200, 999, b).astype(np.int32)
    fg, img = _masks(b)
    mk = {} if rand_face else dict(fg=fg, img=img)
    j = jts.ZeroShotArc2FaceBatch(
        latents=jnp.asarray(x["lat"]), token_ids=jnp.asarray(ids),
        slot_maps={k: jnp.asarray(v) for k, v in slots.items()}, timesteps=jnp.asarray(t),
        noises=jnp.asarray(noises), relative_ts=jnp.asarray(rel),
        fg_mask=None if rand_face else jnp.asarray(fg), clip_fg=jnp.asarray(x["clip_fg"]),
        clip_bg=jnp.asarray(x["clip_bg"]), id_embs=jnp.asarray(x["ids"]),
        img_mask=None if rand_face else jnp.asarray(img))
    p = tts.ZeroShotArc2FaceBatch(
        latents=tt(x["lat"]), token_ids=ids, slot_maps=slots, timesteps=torch.tensor(t),
        noises=tt(noises), relative_ts=tt(rel), fg_mask=tt(mk["fg"]) if mk else None,
        clip_fg=tt(x["clip_fg"]), clip_bg=tt(x["clip_bg"]), id_embs=tt(x["ids"]),
        img_mask=tt(mk["img"]) if mk else None)
    return j, p


@pytest.mark.parametrize("S,b,rand_face,n_steps", [(1, 2, False, 1), (3, 1, True, 3),
                                                    (3, 3, False, 2)])
def test_zs_arc2face_step_matches_jax(zs, S, b, rand_face, n_steps):
    jp, tp = zs["jp"], zs["tp"]
    jb, pb = _a2f_batches(zs, S, b, rand_face, seed=10 + S + b)
    jstep = jts.make_zero_shot_arc2face_step(
        jp.clip, jp.clip_params, jp.unet, jp.unet_params, jp.unet, zs["teacher_params"],
        jp.base_sched, _capture_grads(), **_jax_kw(zs), num_denoising_steps=S,
        use_fg_mask=not rand_face)
    jmetrics, jgrads = _jax_step(jstep, zs, jb, {
        "clip": jp.clip_params, "unet": jp.unet_params, "arc": zs["arc_params"],
        "teacher": jax.tree_util.tree_map(jnp.asarray, zs["teacher_params"])})
    gens = zs["port_gens"](zs["gparams"])
    step = tts.make_zero_shot_arc2face_step(tp.clip, tp.unet, zs["teacher"], tp.base_sched,
                                            None, **_port_kw(zs), num_denoising_steps=S,
                                            use_fg_mask=not rand_face)
    loss, metrics = step.loss_fn(gens, pb)
    assert float(metrics["n_loss_steps"]) == n_steps
    _check(metrics, loss, jmetrics, jgrads, gens)


def test_teacher_trajectory_timesteps_match_jax(zs):
    """The earlier timesteps of a 5-step trajectory (int32 truncation of
    the float32 interpolation) equal JAX's."""
    rng = np.random.default_rng(2)
    t0 = rng.integers(1, 999, 64).astype(np.int32)
    rel = rng.uniform(size=(4, 64)).astype(np.float32)
    js = [jnp.asarray(t0)]
    for i in range(4):
        k = 4 ** -0.3
        lb, ub = js[i] * (0.5 ** k), js[i] * (0.7 ** k)
        js.append(((ub - lb) * jnp.asarray(rel[i]) + lb).astype(jnp.int32))
    class _Teacher(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.in_conv = torch.nn.Conv2d(1, 1, 1)

        def forward(self, x, t, ctx):
            return torch.zeros_like(x)

    batch = tts.Arc2FaceBatch(latents=torch.zeros(64, 2, 2, 4), teacher_context=torch.zeros(
        64, 3, 4), token_ids=None, slot_maps=None, timesteps=torch.tensor(t0),
        noises=torch.zeros(5, 64, 2, 2, 4), relative_ts=tt(rel), fg_mask=None)
    _, ts, _ = tts._teacher_trajectory(_Teacher(), zs["tp"].base_sched, batch,
                                       batch.teacher_context, 5)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------- trainers
def _face_fn(img):
    if int(img.sum()) % 5 == 0:
        return None
    v = np.random.default_rng(int(img.sum())).standard_normal(512)
    return (v / np.linalg.norm(v)).astype(np.float32)


PLAN_KW = dict(composition_regs_iter_gap=3, arc2face_distill_iter_prob=0.6,
               max_num_denoising_steps=3)
N_STEPS = 14


def _trainers(zs, subject_dir, tmp_path, seed=0, **cfg_kw):
    jp, tp = zs["jp"], zs["tp"]
    cfg = dict(dict(batch_size=2, max_steps=100, seed=seed, log_every_steps=1000,
                    ckpt_every_steps=1000), **cfg_kw)
    vis = jcv.CLIPVisionConfig.tiny(hidden_size=VD)
    vparams = _np_tree(jcv.CLIPVisionEncoder(vis).init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, 28, 28, 3)))["params"])
    vision = _load(tcv.CLIPVisionEncoder(tcv.CLIPVisionConfig.tiny(hidden_size=VD)),
                   from_jax.vision_state_dict_from_jax(vparams))
    jtr = JZSTrainer(jp, JDataset([JSpec("s", subject_dir)], size=32, seed=0),
                     JExtractor(jcv.CLIPVisionEncoder(vis), vparams, face_embed_fn=_face_fn),
                     zs["jgens"], jax.tree_util.tree_map(jnp.asarray, zs["gparams"]),
                     jct.CLIPTextEncoder(zs["txt_cfg"]), zs["arc_params"],
                     JTrainerConfig(logdir=str(tmp_path / "j"), **cfg), JPlanConfig(**PLAN_KW),
                     bg_placeholders=frozenset({"y"}))
    ttr = ZeroShotTrainer(tp, PersonalizedDataset([SubjectSpec("s", subject_dir)], size=32,
                                                  seed=0),
                          ZeroShotFeatureExtractor(vision, face_embed_fn=_face_fn),
                          zs["port_gens"](zs["gparams"]), zs["arc"],
                          TrainerConfig(logdir=str(tmp_path / "t"), **cfg),
                          IterPlanConfig(**PLAN_KW), bg_placeholders=frozenset({"y"}))
    return jtr, ttr


def _recording(jtr, ttr):
    jrec, trec = [], []

    def jcall(step, params, opt_state, batch, frozen=None):
        jrec.append(batch)
        return params, opt_state, {}
    jtr._call_step = jcall
    rec = lambda *a: (lambda g, b: trec.append(b) or {})
    ttr._get_zs_recon_step = ttr._get_zs_compos_step = ttr._get_zs_arc2face_step = rec
    return jrec, trec


def _same(a, b, name, exact=True):
    a = np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)
    b = np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if exact:
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=name)


def test_trainers_build_the_same_batches(zs, subject_dir, tmp_path):
    jp, tp = zs["jp"], zs["tp"]
    jtr, ttr = _trainers(zs, subject_dir, tmp_path)
    jrec, trec = _recording(jtr, ttr)
    jtr.fit(N_STEPS, arc2face_teacher=(jp.unet, zs["teacher_params"], None))
    ttr.fit(N_STEPS, arc2face_teacher_unet=zs["teacher"])
    ttr.close()
    assert len(jrec) == len(trec) == N_STEPS
    kinds = set()
    for jb, tb in zip(jrec, trec):
        assert type(jb).__name__ == type(tb).__name__
        kind = type(tb).__name__
        if kind == "ZeroShotArc2FaceBatch":
            S = tb.noises.shape[0]
            kinds.add((kind, S > 1, tb.fg_mask is None,
                       bool(np.all(tb.latents.numpy() == tb.latents.numpy()[:1]))
                       and tb.latents.shape[0] > 1))
            for name in ("noises", "relative_ts"):
                _same(getattr(tb, name), getattr(jb, name), name)
            np.testing.assert_allclose(tb.id_embs.numpy(), np.asarray(jb.id_embs), rtol=0,
                                       atol=1e-7)
        else:
            kinds.add((kind,))
            _same(tb.noise, jb.noise, "noise")
            _same(tb.id_embs, jb.id_embs, "id_embs")
        _same(tb.latents, jb.latents, "latents", exact=False)
        for name in ("token_ids", "timesteps", "fg_mask", "img_mask", "have_fg_mask",
                     "delta_token_ids", "subj_slot_map", "t_frac"):
            a, b = getattr(tb, name, None), getattr(jb, name, None)
            assert (a is None) == (b is None), name
            if a is not None:
                _same(a, b, name)
        for name in ("clip_fg", "clip_bg"):
            _same(getattr(tb, name), getattr(jb, name), name, exact=False)
        assert sorted(tb.slot_maps) == sorted(jb.slot_maps)
        for k in tb.slot_maps:
            _same(tb.slot_maps[k], jb.slot_maps[k], k)
        assert tb.dropout_seed == int(np.asarray(jb.dropout_key)[-1])
        if getattr(jb, "emb_noise_key", None) is not None:
            assert tb.emb_noise_seed == int(np.asarray(jb.emb_noise_key)[-1])
    assert ("ZeroShotReconBatch",) in kinds and ("ZeroShotComposBatch",) in kinds
    a2f = {k[1:] for k in kinds if k[0] == "ZeroShotArc2FaceBatch"}
    assert any(not multi for multi, _, _ in a2f) and any(multi for multi, _, _ in a2f), a2f
    assert any(rand for _, rand, _ in a2f) and any(collapsed for _, _, collapsed in a2f), a2f


def test_noise_id_embs_matches_jax(zs, subject_dir, tmp_path):
    jtr, ttr = _trainers(zs, subject_dir, tmp_path)
    ttr.close()
    e = np.random.default_rng(3).standard_normal((3, 512)).astype(np.float32)
    got = ttr._noise_id_embs(np.broadcast_to(e[:1], e.shape))
    want = np.asarray(jtr._noise_id_embs(jnp.broadcast_to(jnp.asarray(e[:1]), e.shape)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), np.linalg.norm(e[0]), rtol=1e-5)


def test_resume_draws_what_an_uninterrupted_run_draws(zs, subject_dir, tmp_path):
    """fit(4) with a checkpoint at step 2, against a second trainer resumed
    from it: steps 2 and 3 draw the same batches, and the generators and
    the optimizer end bit for bit the same."""
    runs = {}
    for name in ("whole", "resumed"):
        _, tr = _trainers(zs, subject_dir, tmp_path / name, ckpt_every_steps=2)
        rec = []
        for get in ("_get_zs_recon_step", "_get_zs_compos_step", "_get_zs_arc2face_step"):
            real = getattr(tr, get)
            setattr(tr, get, (lambda real: lambda *a: (
                lambda g, b: rec.append(copy.deepcopy(b)) or real(*a)(g, b)))(real))
        if name == "resumed":
            tr.load_checkpoint(str(runs["whole"][2] / "subj_basis_gs-2.pt"))
        tr.fit(4, arc2face_teacher_unet=zs["teacher"])
        tr.close()
        runs[name] = (tr, rec, tmp_path / name / "t")
    (whole, wrec, _), (resumed, rrec, _) = runs["whole"], runs["resumed"]
    assert len(wrec) == 4 and len(rrec) == 2
    for a, b in zip(wrec[2:], rrec):
        assert type(a) is type(b)
        for name, x in a._asdict().items():
            y = getattr(b, name)
            if torch.is_tensor(x):
                assert torch.equal(x, y), name
            elif isinstance(x, dict):
                assert all(np.array_equal(x[k], y[k]) for k in x), name
            elif isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=name)
            else:
                assert x == y, name
    for s in whole.generators:
        for (n, p), (_, q) in zip(whole.generators[s].named_parameters(),
                                  resumed.generators[s].named_parameters()):
            assert torch.equal(p, q), (s, n)
    assert whole.optimizer.inner.step_count == resumed.optimizer.inner.step_count == 2
