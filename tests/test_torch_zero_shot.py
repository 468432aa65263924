"""Port parity of the zero-shot path with the JAX package's, on tiny configs
in fp32 on the CPU, same weights through `interop/from_jax.py` and numpy
inputs from a seed: the text encoder's K/V multipliers and their extension,
the Arc2Face forward and inverse (every emb type), the three branches of
`SubjBasisGenerator`, the feature extractor (a faceless image, `calc_avg`),
`EmbeddingManager.compute_zero_shot_embeddings`, the pipeline's
`set_zero_shot_features` + `encode_prompts`, and `generate` with zero-shot
features and with `context=`. flax's LayerNorm epsilon (1e-6) read as
torch's default (1e-5) must fall outside the tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from adaface_tpu.models import clip_text as jct
from adaface_tpu.models import clip_vision as jcv
from adaface_tpu.models.unet import UNetConfig as JUNetConfig
from adaface_tpu.models.vae import VAEConfig as JVAEConfig
from adaface_tpu.personalization import arc2face as ja2f
from adaface_tpu.personalization import zero_shot as jzs
from adaface_tpu.personalization.embedding_manager import EmbeddingManager as JManager
from adaface_tpu.personalization.subj_basis_generator import SubjBasisGenerator as JGen
from adaface_tpu.pipeline import StableDiffusionPipeline as JPipeline

from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.models import clip_text as tct
from adaface_tpu_torch.models import clip_vision as tcv
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from adaface_tpu_torch.personalization import arc2face as ta2f
from adaface_tpu_torch.personalization import zero_shot as tzs
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.personalization.subj_basis_generator import SubjBasisGenerator
from adaface_tpu_torch.pipeline import StableDiffusionPipeline

torch.set_num_threads(2)

T, D, VD = 77, 64, 48  # template length, text width, vision width
ATOL = 3e-5  # fp32; the house style is 1e-5 to 5e-5
TXT_KW = dict(vocab_size=49408, hidden_size=D, num_layers=2, num_heads=4,
              intermediate_size=128, max_position_embeddings=T)
UNET_KW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               attention_levels=(0, 1), num_heads=4, context_dim=D)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)
PROMPT = "a photo of a z " + ", " * 15 + "y, person"


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _text_encoder(params, **kw):
    m = tct.CLIPTextEncoder(tct.CLIPTextConfig(**{**TXT_KW, **kw}))
    m.load_state_dict(from_jax.clip_state_dict_from_jax(params), strict=True)
    return m.eval()


def _gen_kw(bg):
    if bg:
        return dict(placeholder_is_bg=True, num_out_layers=16, num_out_embs_per_layer=4,
                    output_dim=D, image_embedding_dim=VD, num_heads=4, bg_num_id_vecs=5)
    return dict(placeholder_is_bg=False, num_out_layers=16, num_out_embs_per_layer=16,
                output_dim=D, pad_token_id=49407)


@pytest.fixture(scope="module")
def stack():
    jtok = JHashTokenizer()
    tok = HashTokenizer()
    inv_ids = jtok([ja2f.INVERSE_TEMPLATE], max_length=T)
    fwd_ids = jtok([ja2f.FORWARD_TEMPLATE], max_length=T)
    arc_tid = int(jtok.encode("id")[0])
    np.testing.assert_array_equal(inv_ids, ta2f.make_template_ids(tok, ta2f.INVERSE_TEMPLATE))
    np.testing.assert_array_equal(fwd_ids, ta2f.make_template_ids(tok, ta2f.FORWARD_TEMPLATE))

    vis_cfg = jcv.CLIPVisionConfig.tiny(hidden_size=VD)
    vparams = _tree(jcv.CLIPVisionEncoder(vis_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)))["params"])
    vision = tcv.CLIPVisionEncoder(tcv.CLIPVisionConfig.tiny(hidden_size=VD))
    vision.load_state_dict(from_jax.vision_state_dict_from_jax(vparams), strict=True)

    txt_cfg = jct.CLIPTextConfig(**TXT_KW)
    arc_params = _tree(jct.CLIPTextEncoder(txt_cfg).init(
        jax.random.PRNGKey(1), input_ids=jnp.zeros((1, T), jnp.int32))["params"])

    jfg = JGen(**_gen_kw(False), proj_cfg=txt_cfg)
    fg_params = _tree(jfg.init(jax.random.PRNGKey(2), None, None, jnp.zeros((1, 16, D)),
                               inverse_template_ids=jnp.asarray(inv_ids))["params"])
    # the object branch's leaves come from an init through that branch
    obj = _tree(jfg.init(jax.random.PRNGKey(4), None, jnp.zeros((1, 384)), None,
                         is_face=False)["params"])
    fg_params.update({k: obj[k] for k in ("obj_proj_dense", "obj_proj_ln")})
    jbg = JGen(**_gen_kw(True))
    bg_params = _tree(jbg.init(jax.random.PRNGKey(3), jnp.zeros((1, 5, VD)), None,
                               None)["params"])

    fg = SubjBasisGenerator(**_gen_kw(False), proj_cfg=tct.CLIPTextConfig(**TXT_KW))
    from_jax.load_subj_basis_generator_from_jax(fg, fg_params)
    bg = from_jax.load_subj_basis_generator_from_jax(SubjBasisGenerator(**_gen_kw(True)),
                                                     bg_params)
    return dict(jtok=jtok, tok=tok, inv_ids=inv_ids, fwd_ids=fwd_ids, arc_tid=arc_tid,
                vis_cfg=vis_cfg, vparams=vparams, vision=vision.eval(),
                txt_cfg=txt_cfg, arc_params=arc_params, arc=_text_encoder(arc_params),
                jfg=jfg, fg_params=fg_params, fg=fg.eval(),
                jbg=jbg, bg_params=bg_params, bg=bg.eval())


# ------------------------------------------------------------ text encoder

@pytest.mark.parametrize("m", [1, 2])
def test_kv_multipliers_match_jax(m):
    """Each layer's K/V copies (initialized apart, so that a wrong copy
    layout would show) with the copy index innermost, next to the sequence."""
    cfg = jct.CLIPTextConfig(**TXT_KW, kv_multipliers=(m, 1))
    params = _tree(jct.CLIPTextEncoder(cfg).init(
        jax.random.PRNGKey(7), input_ids=jnp.zeros((1, T), jnp.int32))["params"])
    ids = np.random.default_rng(0).integers(0, 49406, (2, T)).astype(np.int32)
    ref = jct.CLIPTextEncoder(cfg).apply({"params": params}, jnp.asarray(ids),
                                         skip_weights=jnp.asarray([0.5, 0.5]))
    port = _text_encoder(params, kv_multipliers=(m, 1))
    assert port.layers_0.self_attn.k_proj.weight.shape == (D * m, D)
    with torch.no_grad():
        got = port(_t(ids).long(), skip_weights=(0.5, 0.5))
    _close(got, ref)


def test_extend_clip_mkv_params_matches_jax(stack):
    """Noise 0: the same tiled state, config and outputs as JAX's, and a
    second extension of the first layer on top of the first."""
    cfg, params = stack["txt_cfg"], stack["arc_params"]
    jp, jcfg = ja2f.extend_clip_mkv_params(params, cfg, jax.random.PRNGKey(0),
                                           multiplier=2, noise_std=0.0)
    jp, jcfg = ja2f.extend_clip_mkv_params(jp, jcfg, jax.random.PRNGKey(1), multiplier=3,
                                           noise_std=0.0, begin_layer_idx=0, end_layer_idx=1)
    tcfg0 = tct.CLIPTextConfig(**TXT_KW)
    sd, tcfg = ta2f.extend_clip_mkv_params(stack["arc"].state_dict(), tcfg0, multiplier=2,
                                           noise_std=0.0)
    sd, tcfg = ta2f.extend_clip_mkv_params(sd, tcfg, multiplier=3, noise_std=0.0,
                                           begin_layer_idx=0, end_layer_idx=1)
    assert jcfg.kv_multipliers == tcfg.kv_multipliers == (6, 2)
    want = from_jax.clip_state_dict_from_jax(_tree(jp))
    assert set(sd) == set(want)
    for k in sd:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    port = tct.CLIPTextEncoder(tcfg)
    port.load_state_dict(sd, strict=True)
    ids = stack["inv_ids"]
    ref = jct.CLIPTextEncoder(jcfg).apply({"params": jp}, jnp.asarray(ids))
    with torch.no_grad():
        _close(port.eval()(_t(ids).long()), ref)


def test_extend_clip_mkv_params_noise():
    """Noise > 0: the original rows and biases stay, the extra copies move by
    about noise_std times the weights' std, and one seed repeats."""
    cfg = tct.CLIPTextConfig.tiny()
    enc = tct.CLIPTextEncoder(cfg)
    sd0 = enc.state_dict()
    run = lambda seed: ta2f.extend_clip_mkv_params(
        sd0, cfg, torch.Generator().manual_seed(seed), multiplier=2, noise_std=0.1)[0]
    a, b, c = run(0), run(0), run(1)
    for i in range(cfg.num_layers):
        for p in ("k_proj", "v_proj"):
            w0 = sd0[f"layers_{i}.self_attn.{p}.weight"]
            w = a[f"layers_{i}.self_attn.{p}.weight"]
            assert torch.equal(w[:w0.shape[0]], w0)
            assert torch.equal(a[f"layers_{i}.self_attn.{p}.bias"],
                               sd0[f"layers_{i}.self_attn.{p}.bias"].repeat(2))
            delta = (w[w0.shape[0]:] - w0).std() / w0.t().std(dim=-1, unbiased=False).mean()
            assert 0.07 < float(delta) < 0.13
            assert torch.equal(w, b[f"layers_{i}.self_attn.{p}.weight"])
            assert not torch.equal(w, c[f"layers_{i}.self_attn.{p}.weight"])


# ----------------------------------------------------------------- arc2face

@pytest.mark.parametrize("hidden", [D, 544])
def test_forward_face_embs_matches_jax(stack, hidden):
    """The 512-d embedding truncated to a 64-wide encoder, zero-padded to a
    544-wide one."""
    if hidden == D:
        cfg, params, port = stack["txt_cfg"], stack["arc_params"], stack["arc"]
    else:
        kw = dict(TXT_KW, hidden_size=hidden, num_layers=1, intermediate_size=64)
        cfg = jct.CLIPTextConfig(**kw)
        params = _tree(jct.CLIPTextEncoder(cfg).init(
            jax.random.PRNGKey(5), input_ids=jnp.zeros((1, T), jnp.int32))["params"])
        port = _text_encoder(params, **kw)
    faces = np.random.default_rng(1).standard_normal((3, 512)).astype(np.float32)
    rf, rc = ja2f.forward_face_embs(jct.CLIPTextEncoder(cfg), params, jnp.asarray(faces),
                                    jnp.asarray(stack["fwd_ids"]), stack["arc_tid"])
    with torch.no_grad():
        gf, gc = ta2f.forward_face_embs(port, _t(faces), stack["fwd_ids"], stack["arc_tid"])
    _close(gf, rf)
    _close(gc, rc)
    assert gc.shape == (3, 16, hidden)


@pytest.mark.parametrize("emb_type", ta2f.EMB_TYPES)
@pytest.mark.parametrize("extra_words", [False, True])
def test_inverse_face_prompt_embs_matches_jax(stack, emb_type, extra_words):
    cfg, params, port = stack["txt_cfg"], stack["arc_params"], stack["arc"]
    core = np.random.default_rng(2).standard_normal((2, 16, D)).astype(np.float32)
    hslw = np.array([[1.0], [2.0], [4.0]], np.float32)
    jenc = jct.CLIPTextEncoder(cfg)
    jpad = ja2f.make_pad_embeddings(jenc, params, 49407, T)
    ref = ja2f.inverse_face_prompt_embs(
        jenc, params, jnp.asarray(core), jnp.asarray(stack["inv_ids"]), jpad,
        (emb_type, "core"), hidden_state_layer_weights=jnp.asarray(hslw),
        extra_words_embs=extra_words, zs_extra_words_scale=0.3)
    with torch.no_grad():
        pad = ta2f.make_pad_embeddings(port, 49407, T)
        _close(pad, jpad)
        got = ta2f.inverse_face_prompt_embs(
            port, _t(core), stack["inv_ids"], pad, (emb_type, "core"),
            hidden_state_layer_weights=_t(hslw), extra_words_embs=extra_words,
            zs_extra_words_scale=0.3)
    for g, r in zip(got, ref):
        _close(g, r)


def test_inverse_rejects_an_unknown_emb_type(stack):
    with pytest.raises(ValueError, match="unknown emb type"):
        ta2f.inverse_face_prompt_embs(stack["arc"], torch.zeros(1, 16, D), stack["inv_ids"],
                                      torch.zeros(T, D), ("half",))


# -------------------------------------------------------------- generators

def _gen_inputs(seed, b=2, clip_scale=1.0):
    rng = np.random.default_rng(seed)
    return dict(clip=(clip_scale * rng.standard_normal((b, 5, VD))).astype(np.float32),
                raw=rng.standard_normal((b, 384)).astype(np.float32),
                arc=rng.standard_normal((b, 16, D)).astype(np.float32))


def _run_generators(stack, branch, scale, inputs, port=None):
    bg = branch == "bg"
    is_face = branch != "fg object"
    jgen, params = (stack["jbg"], stack["bg_params"]) if bg else (stack["jfg"],
                                                                 stack["fg_params"])
    port = port or (stack["bg"] if bg else stack["fg"])
    args = ((inputs["clip"], None, None) if bg else
            (None, None, inputs["arc"]) if is_face else (None, inputs["raw"], None))
    kw = dict(out_id_embs_scale=scale, is_face=is_face,
              inverse_template_ids=stack["inv_ids"],
              arc2face_inverse_prompt_embs_inf_type="full_half_pad")
    ref = jgen.apply({"params": params}, *(None if a is None else jnp.asarray(a)
                                           for a in args),
                     **dict(kw, inverse_template_ids=jnp.asarray(stack["inv_ids"])))
    with torch.no_grad():
        got = port(*(None if a is None else _t(a) for a in args), **kw)
    return got, ref


@pytest.mark.parametrize("branch", ["bg", "fg face", "fg object"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_generator_matches_jax(stack, branch, scale):
    (got, inv), (ref, rinv) = _run_generators(stack, branch, scale, _gen_inputs(3))
    K = 4 if branch == "bg" else 16
    assert got.shape == (2, 16, K, D)
    _close(got, ref)
    if branch == "fg face":
        _close(inv, rinv)
    else:
        assert inv is None and rinv is None


def test_generator_is_training_takes_full_pad(stack):
    inputs = _gen_inputs(4)
    jg, jp = stack["jfg"], stack["fg_params"]
    _, rinv = jg.apply({"params": jp}, None, None, jnp.asarray(inputs["arc"]),
                       is_training=True, inverse_template_ids=jnp.asarray(stack["inv_ids"]))
    with torch.no_grad():
        _, inv = stack["fg"](None, None, _t(inputs["arc"]), is_training=True,
                             inverse_template_ids=stack["inv_ids"])
    _close(inv, rinv)


def test_torch_layer_norm_eps_falls_outside(stack):
    """Every LayerNorm of the generators is flax's, eps 1e-6. With torch's
    default 1e-5 in their place the bg output leaves the tolerance where
    the projected features are small, as masked-out ones are; the right
    eps stays inside it on the same input."""
    inputs = _gen_inputs(5, clip_scale=0.01)
    got, ref = _run_generators(stack, "bg", 1.0, inputs)
    _close(got[0], ref[0])
    wrong = SubjBasisGenerator(**_gen_kw(True))
    wrong.load_state_dict(stack["bg"].state_dict())
    for mod in wrong.modules():
        if isinstance(mod, torch.nn.LayerNorm):
            assert mod.eps == 1e-6
            mod.eps = 1e-5
    (bad, _), (ref, _) = _run_generators(stack, "bg", 1.0, inputs, port=wrong.eval())
    assert np.abs(bad.numpy() - np.asarray(ref)).max() > 10 * ATOL


def test_generator_loader_refuses_a_foreign_tree(stack):
    tree = dict(stack["bg_params"], stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray"):
        from_jax.load_subj_basis_generator_from_jax(SubjBasisGenerator(**_gen_kw(True)), tree)
    fg = dict(stack["fg_params"])
    del fg["hidden_state_layer_weights"]
    with pytest.raises(ValueError, match="hidden_state_layer_weights"):
        from_jax.load_subj_basis_generator_from_jax(
            SubjBasisGenerator(**_gen_kw(False), proj_cfg=tct.CLIPTextConfig(**TXT_KW)), fg)


def test_train_mode_generator_loaded_from_jax_is_deterministic(stack):
    """A bg generator built and loaded from JAX's tree without `.eval()`
    (a fresh module is in train mode) gives JAX's deterministic output, and
    twice the same: dropout runs only on a generator the caller passes."""
    port = from_jax.load_subj_basis_generator_from_jax(
        SubjBasisGenerator(**_gen_kw(True)), stack["bg_params"])
    assert port.training
    inputs = _gen_inputs(7)
    (got, _), (ref, _) = _run_generators(stack, "bg", 1.0, inputs, port=port)
    _close(got, ref)
    (again, _), _ = _run_generators(stack, "bg", 1.0, inputs, port=port)
    assert torch.equal(got, again)


def _bg_with_dropout(stack, seed, index=1):
    from adaface_tpu_torch.personalization.subj_basis_generator import dropout_stream

    with torch.no_grad():
        out, _ = stack["bg"](_t(_gen_inputs(8)["clip"]), None, None,
                             dropout_generator=dropout_stream(seed, index, "cpu"))
    return out


def test_generator_dropout_repeats_by_seed(stack):
    """One seed repeats its masks bit for bit, another seed or another
    generator's stream of the same seed differs, and no seed is the
    deterministic output."""
    from adaface_tpu_torch.personalization.subj_basis_generator import dropout_stream

    a, b = _bg_with_dropout(stack, 11), _bg_with_dropout(stack, 11)
    assert torch.equal(a, b)
    assert not torch.equal(a, _bg_with_dropout(stack, 12))
    assert not torch.equal(a, _bg_with_dropout(stack, 11, index=0))
    (plain, _), _ = _run_generators(stack, "bg", 1.0, _gen_inputs(8))
    assert not torch.equal(a, plain)
    assert dropout_stream(None, 0, "cpu") is None


def test_attention_dropout_drops_five_percent():
    """Over 2^22 attention weights the dropped share is 5% +- 1%, and the
    kept ones are divided by 0.95 (flax's Dropout)."""
    from adaface_tpu_torch.personalization.subj_basis_generator import (
        attention_dropout, dropout_stream)

    attn = torch.full((4, 4, 512, 512), 0.25)
    out = attention_dropout(attn, 0.05, dropout_stream(3, 0, "cpu"))
    dropped = float((out == 0).float().mean())
    assert 0.04 <= dropped <= 0.06, dropped
    kept = out[out != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 0.25 / 0.95))
    assert attention_dropout(attn, 0.05, None) is attn


# --------------------------------------------------------- feature extractor

def _images(seed):
    rng = np.random.default_rng(seed)
    shapes = [(40, 32), (28, 28), (50, 61), (33, 30)]
    imgs = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in shapes]
    masks = [(rng.random(s) > 0.5).astype(np.float32) for s in shapes]
    masks[2] = masks[2][..., None]  # a trailing channel is dropped
    return imgs, masks


def _face_fn(seed, faceless=(1,)):
    calls = []

    def fn(img):
        calls.append(1)
        if len(calls) - 1 in faceless:
            return None
        v = np.random.default_rng(seed + int(img.sum())).standard_normal(512)
        return (v / np.linalg.norm(v)).astype(np.float32)
    return fn


@pytest.mark.parametrize("calc_avg", [True, False])
def test_encode_matches_jax(stack, calc_avg):
    """A faceless image gets the numpy rng's draw (so the same numbers as
    JAX's) and is counted; calc_avg averages and L2-normalizes."""
    imgs, masks = _images(6)
    jex = jzs.ZeroShotFeatureExtractor(jcv.CLIPVisionEncoder(stack["vis_cfg"]),
                                       stack["vparams"], face_embed_fn=_face_fn(0))
    ref = jex.encode(imgs, masks, is_face=True, calc_avg=calc_avg)
    ex = tzs.ZeroShotFeatureExtractor(stack["vision"], face_embed_fn=_face_fn(0))
    got = ex.encode(imgs, masks, is_face=True, calc_avg=calc_avg)
    assert got.faceless_img_count == ref.faceless_img_count == 1
    _close(got.clip_fg, ref.clip_fg)
    _close(got.clip_bg, ref.clip_bg)
    _close(got.clip_features, ref.clip_features)
    _close(got.id_embs, ref.id_embs, atol=1e-6)
    if calc_avg:
        assert got.clip_fg.shape == (1, 5, VD)
        assert abs(float(torch.linalg.vector_norm(got.id_embs)) - 1.0) < 1e-6
    # the negative features are cached: a second call repeats bit for bit
    again = ex.encode(imgs, masks, is_face=True, calc_avg=calc_avg)
    assert torch.equal(again.clip_fg, got.clip_fg)


def test_encode_without_masks_and_dino(stack):
    imgs, _ = _images(7)
    dino = lambda img: np.full(384, float(img.mean()) / 255.0, np.float32)
    jex = jzs.ZeroShotFeatureExtractor(jcv.CLIPVisionEncoder(stack["vis_cfg"]),
                                       stack["vparams"], dino_embed_fn=dino)
    ref = jex.encode(imgs, None, is_face=False)
    got = tzs.ZeroShotFeatureExtractor(stack["vision"], dino_embed_fn=dino).encode(
        imgs, None, is_face=False)
    _close(got.clip_fg, ref.clip_fg)
    _close(got.clip_bg, ref.clip_bg)
    _close(got.id_embs, ref.id_embs, atol=0)
    assert got.faceless_img_count == 0


def test_encode_skips_non_faces(stack):
    imgs, masks = _images(8)
    ex = tzs.ZeroShotFeatureExtractor(stack["vision"], face_embed_fn=_face_fn(0, (1, 3)))
    feats = ex.encode(imgs, masks, skip_non_faces=True)
    assert feats.clip_fg.shape[0] == 2 and feats.faceless_img_count == 0
    ex = tzs.ZeroShotFeatureExtractor(stack["vision"], face_embed_fn=lambda img: None)
    with pytest.raises(ValueError, match="no usable reference images"):
        ex.encode(imgs, masks, skip_non_faces=True)


# ------------------------------------------------- manager and pipeline

def _features(seed, b=2):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, 5, VD)).astype(np.float32) for _ in range(2)]
    ids = rng.standard_normal((b, 512)).astype(np.float32)
    return (jzs.ZeroShotFeatures(*(jnp.asarray(a) for a in arrs), jnp.asarray(ids)),
            tzs.ZeroShotFeatures(*(_t(a) for a in arrs), _t(ids)))


def _managers(stack, jmgr=None, mgr=None):
    jmgr = jmgr if jmgr is not None else JManager()
    mgr = mgr if mgr is not None else EmbeddingManager()
    zj, yj = stack["jtok"].add_placeholder("z"), stack["jtok"].add_placeholder("y")
    assert (stack["tok"].add_placeholder("z"), stack["tok"].add_placeholder("y")) == (zj, yj)
    jmgr.add_zero_shot_placeholder("z", zj, stack["jfg"], stack["fg_params"])
    jmgr.add_zero_shot_placeholder("y", yj, stack["jbg"], stack["bg_params"],
                                   is_background=True)
    jmgr.arc2face_encoder = (jct.CLIPTextEncoder(stack["txt_cfg"]), stack["arc_params"])
    mgr.add_zero_shot_placeholder("z", zj, stack["fg"])
    mgr.add_zero_shot_placeholder("y", yj, stack["bg"], is_background=True)
    mgr.arc2face_encoder = stack["arc"]
    return jmgr, mgr


@pytest.mark.parametrize("inf_type", ["full_half_pad", "full_pad"])
def test_compute_zero_shot_embeddings_matches_jax(stack, inf_type):
    jmgr, mgr = _managers(stack)
    assert mgr.placeholders["z"].num_vectors == 16 and mgr.placeholders["y"].num_vectors == 4
    jf, tf = _features(9)
    kw = dict(arcface_token_id=stack["arc_tid"], out_id_embs_scale=0.7, inf_emb_type=inf_type)
    ref, rinv = jmgr.compute_zero_shot_embeddings(
        jf, jnp.asarray(stack["inv_ids"]),
        forward_template_ids=jnp.asarray(stack["fwd_ids"]), **kw)
    with torch.no_grad():
        got, inv = mgr.compute_zero_shot_embeddings(
            tf, stack["inv_ids"], forward_template_ids=stack["fwd_ids"], **kw)
    assert got["z"].shape == (16, 2, 16, D) and got["y"].shape == (16, 2, 4, D)
    for s in ("z", "y"):
        _close(got[s], ref[s])
    _close(inv, rinv)


def test_num_vectors_must_match_the_generator(stack):
    with pytest.raises(ValueError, match="num_out_embs_per_layer=4"):
        EmbeddingManager().add_zero_shot_placeholder("y", 49409, stack["bg"], num_vectors=5)


def _pipelines(stack):
    clip_kw = dict(TXT_KW, num_extra_tokens=4)
    jp = JPipeline.from_random(jax.random.PRNGKey(1), stack["jtok"], JUNetConfig(**UNET_KW),
                               JVAEConfig(**VAE_KW), jct.CLIPTextConfig(**clip_kw))
    clip = tct.CLIPTextEncoder(tct.CLIPTextConfig(**clip_kw))
    clip.load_state_dict(from_jax.clip_state_dict_from_jax(_tree(jp.clip_params)), strict=True)
    unet = UNetModel(UNetConfig(**UNET_KW))
    unet.load_state_dict(from_jax.unet_state_dict_from_jax(_tree(jp.unet_params)), strict=True)
    vae = AutoencoderKL(VAEConfig(**VAE_KW))
    vae.load_state_dict(from_jax.vae_state_dict_from_jax(_tree(jp.vae_params)), strict=True)
    tp = StableDiffusionPipeline(stack["tok"], clip, unet, vae)
    _managers(stack, jp.embedding_manager, tp.embedding_manager)
    return jp, tp


@pytest.fixture(scope="module")
def pipelines(stack):
    jp, tp = _pipelines(stack)
    jf, tf = _features(10, b=1)
    args = (stack["fwd_ids"], stack["inv_ids"], stack["arc_tid"])
    jp.set_zero_shot_features(jf, *args)
    tp.set_zero_shot_features(tf, *args)
    return jp, tp


def test_encode_prompts_matches_jax(stack, pipelines):
    jp, tp = pipelines
    prompts = [PROMPT, PROMPT, "a photo of a z , , person"]
    ref = jp.encode_prompts(prompts)
    got = tp.encode_prompts(prompts)
    assert got.shape == (16, 3, T, D)
    _close(got, ref)
    # a second identity moves the context; the same one repeats it
    jf2, tf2 = _features(11, b=1)
    tp2 = StableDiffusionPipeline(stack["tok"], tp.clip, tp.unet, tp.vae, tp.embedding_manager)
    tp2.set_zero_shot_features(tf2, stack["fwd_ids"], stack["inv_ids"], stack["arc_tid"])
    assert float((tp2.encode_prompts(prompts) - got).abs().max()) > 1e-3
    assert torch.equal(tp.encode_prompts(prompts), got)


def test_generate_matches_jax_within_one_level(pipelines):
    """x_T given, 2 DDIM steps, annealed CFG; the uint8 images within one
    level, the bar of tests/test_torch_pipeline.py. A repeated prompt is
    encoded once (the row dedup) and gives the rows of the batch."""
    jp, tp = pipelines
    prompts = [PROMPT, "a photo of a z , , person", PROMPT]
    x_T = np.random.default_rng(0).standard_normal((3, 16, 16, 4)).astype(np.float32)
    kw = dict(num_steps=2, guidance_scale=(10.0, 4.0), height=32, width=32, x_T=x_T,
              negative_prompt="ugly, blurry")
    ref = jp.generate(prompts, **kw)
    got = tp.generate(prompts, **kw)
    assert got.shape == (3, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert got.std() > 1


@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_generate_with_context_matches_jax(stack, pipelines, mode):
    """The Arc2Face evaluation modes: the raw forward embeddings or the
    inverse ones drive the UNet; [1, 1, T, D] broadcasts over the layers
    and the batch."""
    jp, tp = pipelines
    jf, tf = _features(12, b=1)
    if mode == "forward":
        ctx, _ = ja2f.forward_face_embs(jct.CLIPTextEncoder(stack["txt_cfg"]),
                                        stack["arc_params"], jf.id_embs,
                                        jnp.asarray(stack["fwd_ids"]), stack["arc_tid"])
    else:
        _, ctx = jp.embedding_manager.compute_zero_shot_embeddings(
            jf, jnp.asarray(stack["inv_ids"]), forward_template_ids=jnp.asarray(stack["fwd_ids"]),
            arcface_token_id=stack["arc_tid"], inf_emb_type="full_pad")
    ctx = np.asarray(ctx)[None, :1]
    x_T = np.random.default_rng(1).standard_normal((2, 16, 16, 4)).astype(np.float32)
    kw = dict(num_steps=2, guidance_scale=5.0, height=32, width=32, x_T=x_T)
    ref = jp.generate([PROMPT] * 2, context=jnp.asarray(ctx), **kw)
    got = tp.generate([PROMPT] * 2, context=_t(ctx), **kw)
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_pipeline_without_zero_shot_is_unchanged(stack):
    """Generators registered but no features set: the static path, as JAX
    takes it (the zero-shot placeholders then carry their extra-vocabulary
    rows)."""
    jp, tp = _pipelines(stack)
    ref = jp.encode_prompts([PROMPT])
    got = tp.encode_prompts([PROMPT])
    _close(got, ref)


def test_random_generators_take_their_flax_initializers():
    from adaface_tpu_torch.pipeline import build_random

    fg = build_random(lambda: SubjBasisGenerator(
        **_gen_kw(False), proj_cfg=tct.CLIPTextConfig(**TXT_KW)), 0, "cpu")
    bg = build_random(lambda: SubjBasisGenerator(**_gen_kw(True)), 1, "cpu")
    assert fg.hidden_state_layer_weights.flatten().tolist() == [1.0, 2.0, 4.0]
    for p in (fg.pos_embs, bg.pos_embs, bg.latent_queries):
        assert 0.9 < float(p.detach().std()) < 1.1
    assert float(bg.bg_proj_dense.weight.detach().std()) < 0.03
    assert not fg.training and dataclasses.is_dataclass(fg.prompt2token_proj.cfg)
