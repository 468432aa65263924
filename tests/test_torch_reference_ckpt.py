"""Reference `embeddings_gs-*.pt` checkpoints in the port, against the JAX
package's loader on the CPU (tiny widths, fp32). The reference tree is
absent here, so the checkpoints are written with stand-in classes pickled
under the reference's module names (`tests/torch_serve_helpers.py`): static
embedders (one with init-word `pre_vecs`, a background one without, and the
zero-shot passthrough with neither) and subject-basis generators (an fg one
whose text encoder carries its HF config, a bg one). Both loaders must give
the same placeholders (token ids through a resolver and sequential,
K from the bias, the bg flag), scores in `string_to_token_dict` order, conv
kernel size, static embeddings (atol 1e-6) and generator outputs (atol
3e-5), under a placeholder remap, and for both MKV load-time extensions: an
unextended checkpoint extended on every layer, and one already extended by
2 extended on layers 0-3 by the ratio (noise ratio 0, so the numbers are
the same in both packages)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaface_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from adaface_tpu.interop import subj_basis as jsb
from adaface_tpu.personalization.embedding_manager import EmbeddingManager as JManager
from adaface_tpu.personalization.static_embedding import (
    compute_static_embedding as jcompute)

from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.interop import subj_basis as tsb
from adaface_tpu_torch.models.clip_text import CLIPTextConfig
from adaface_tpu_torch.personalization import arc2face as ta2f
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.personalization.static_embedding import compute_static_embedding
from adaface_tpu_torch.personalization.subj_basis_generator import SubjBasisGenerator
from adaface_tpu_torch.pipeline import build_random
from tests import torch_serve_helpers as helpers

torch.set_num_threads(2)

D, BG_D, VD, LAYERS = 64, 96, 48, 4
ATOL = 3e-5
PROJ = dict(vocab_size=49408, hidden_size=D, num_layers=LAYERS, num_heads=4,
            intermediate_size=128, max_position_embeddings=77)
HF_CONFIG = dict(hidden_size=D, num_hidden_layers=LAYERS, num_attention_heads=4,
                 intermediate_size=128, vocab_size=49408, max_position_embeddings=77,
                 layer_norm_eps=1e-5)


def _static(seed, K, r, with_pre, basis=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    n = 1 if with_pre else 0
    return {"basis_rand_weights": f(16, K, r), "basis_comm_weights": f(1, K, r),
            "basis_vecs": f(K, r - n, D) if basis else None,
            "pre_vecs": f(K, n, D) if with_pre and basis else None,
            "bias": 0.05 * f(16, K, D)}


def _fg(seed, kv=None):
    return build_random(lambda: SubjBasisGenerator(
        placeholder_is_bg=False, output_dim=D, dino_embedding_dim=12,
        proj_cfg=CLIPTextConfig(**PROJ, kv_multipliers=kv)), seed, "cpu")


def _bg(seed):
    return build_random(lambda: SubjBasisGenerator(
        placeholder_is_bg=True, num_out_embs_per_layer=4, output_dim=BG_D,
        image_embedding_dim=VD, bg_num_id_vecs=5), seed, "cpu")


def _ref_flat(gen, bg):
    """The generator in the reference's names; a reference fg generator also
    holds a pos_embs LayerNorm, which it never reads."""
    flat = tsb.export_subj_basis_generator(gen.state_dict(), bg)
    if not bg:
        flat.update({"pos_embs_ln.weight": torch.ones(D), "pos_embs_ln.bias": torch.zeros(D)})
    return flat


def _standin(gen, bg):
    flat = _ref_flat(gen, bg)
    mod = helpers.module_from_flat(helpers.SubjBasisGenerator, flat, placeholder_is_bg=bg,
                                   num_out_layers=16,
                                   num_out_embs_per_layer=4 if bg else 16)
    if not bg:
        mod.prompt2token_proj.config = helpers.CLIPTextConfigStandIn(**HF_CONFIG)
    return mod


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "embeddings_gs-100.pt")
    fg, bg = _fg(1), _bg(2)
    with helpers.reference_modules():
        gens = {"s": _standin(fg, False), "y": _standin(bg, True)}
    helpers.save_reference_embeddings(
        path, {"z": _static(3, 3, 4, True), "y": _static(4, 2, 4, False),
               "s": _static(5, 16, 4, False, basis=False)},
        generators=gens, token2num={"z": 3, "y": 2, "s": 16}, background=("y",), conv_ks=2,
        scores={"z": 0.25, "y": -1.5, "s": 0.75})
    return dict(path=path, fg=fg, bg=bg)


def _load_both(path, **kw):
    jtok, tok = JHashTokenizer(), HashTokenizer()
    jm = JManager().load_reference_checkpoint(path, token_id_resolver=jtok.add_placeholder,
                                              **kw)
    tm = EmbeddingManager().load_reference_checkpoint(path,
                                                      token_id_resolver=tok.add_placeholder,
                                                      **kw)
    return jm, tm


def _close(got, want, atol=ATOL):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("resolver", [True, False])
def test_placeholders_scores_and_static_embeddings(ckpt, resolver):
    if resolver:
        jm, tm = _load_both(ckpt["path"], load_subj_basis_generators=False)
    else:
        jm = JManager().load_reference_checkpoint(ckpt["path"], load_subj_basis_generators=False)
        tm = EmbeddingManager().load_reference_checkpoint(ckpt["path"],
                                                          load_subj_basis_generators=False)
    assert list(tm.placeholders) == list(jm.placeholders) == ["z", "y", "s"]
    for s, info in jm.placeholders.items():
        got = tm.placeholders[s]
        assert (got.token_id, got.num_vectors, got.is_background) == (
            info.token_id, info.num_vectors, info.is_background), s
    assert [tm.placeholders[s].num_vectors for s in "zys"] == [3, 2, 16]
    assert tm.placeholders["y"].is_background
    assert tm.emb_global_scale_scores == jm.emb_global_scale_scores == {
        "z": 0.25, "y": -1.5, "s": 0.75}
    assert tm.use_conv_attn_kernel_size == jm.use_conv_attn_kernel_size == 2
    # the zero-shot passthrough registers its placeholder, no embedder
    assert sorted(tm.embedders) == sorted(jm.embedders) == ["y", "z"]
    for s in ("z", "y"):
        _close(compute_static_embedding(tm.embedders[s]), jcompute(jm.embedders[s]), 1e-6)


def test_placeholder_remap(ckpt):
    jm, tm = _load_both(ckpt["path"], placeholder_remap={"z": "z2", "s": "q"})
    assert list(tm.placeholders) == list(jm.placeholders) == ["z2", "y", "q"]
    assert sorted(tm.subj_basis_generators) == sorted(jm.subj_basis_generators) == ["q", "y"]
    _close(compute_static_embedding(tm.embedders["z2"]), jcompute(jm.embedders["z2"]), 1e-6)


def test_conv_kernel_size_absent(tmp_path):
    path = str(tmp_path / "e.pt")
    helpers.save_reference_embeddings(path, {"z": _static(3, 3, 4, True)}, conv_ks=None)
    jm, tm = _load_both(path)
    assert tm.use_conv_attn_kernel_size == jm.use_conv_attn_kernel_size == -1


def _run(jm, tm, s, seed):
    """Each manager's generator `s` on one input: the fg face branch (with
    its inverse prompt embeddings) or the bg branch."""
    gen = tm.subj_basis_generators[s]
    jgen, jparams = jm.subj_basis_generators[s]
    rng = np.random.default_rng(seed)
    tok = HashTokenizer()
    inv_ids = ta2f.make_template_ids(tok, ta2f.INVERSE_TEMPLATE)
    if gen.placeholder_is_bg:
        args = (rng.standard_normal((2, 5, VD)).astype(np.float32), None, None)
    else:
        args = (None, None, rng.standard_normal((2, 16, D)).astype(np.float32))
    kw = dict(out_id_embs_scale=0.8, is_face=True)
    ref = jgen.apply({"params": jparams}, *(None if a is None else jnp.asarray(a) for a in args),
                     inverse_template_ids=jnp.asarray(inv_ids), **kw)
    with torch.no_grad():
        got = gen(*(None if a is None else torch.from_numpy(a) for a in args),
                  inverse_template_ids=inv_ids, **kw)
    return got, ref


@pytest.mark.parametrize("s", ["s", "y"])
def test_generators_equal_jax_and_the_written_module(ckpt, s):
    jm, tm = _load_both(ckpt["path"])
    gen = tm.subj_basis_generators[s]
    assert tm.placeholders[s].is_background == (s == "y") == jm.placeholders[s].is_background
    (got, inv), (ref, rinv) = _run(jm, tm, s, 7)
    _close(got, ref)
    if s == "s":
        _close(inv, rinv)
    # and the loaded generator is the one written, bit for bit
    src = ckpt["fg"] if s == "s" else ckpt["bg"]
    for k, v in src.state_dict().items():
        assert torch.equal(gen.state_dict()[k], v), k


@pytest.mark.parametrize("case", ["unextended x2", "extended by 2, x4"])
def test_mkv_extension_at_load(tmp_path, case):
    kv0, mult = ((None, 2) if case == "unextended x2" else ((2,) * LAYERS, 4))
    path = str(tmp_path / "zs.pt")
    with helpers.reference_modules():
        gens = {"s": _standin(_fg(11, kv0), False)}
    helpers.save_reference_embeddings(path, {}, generators=gens)
    jm, tm = _load_both(path, extend_attention_multiplier=mult)
    want = (2, 2, 2, 2) if kv0 is None else (4, 4, 4, 2)  # layers 0-3: 0, 1, 2
    gen = tm.subj_basis_generators["s"]
    assert gen.prompt2token_proj.cfg.kv_multipliers == want
    jgen, _ = jm.subj_basis_generators["s"]
    assert tuple(jgen.proj_cfg.kv_multipliers) == want
    # a zero-shot-only placeholder: JAX's id rule, not the resolver's
    assert tm.placeholders["s"].token_id == jm.placeholders["s"].token_id == 49408
    (got, inv), (ref, rinv) = _run(jm, tm, "s", 8)
    _close(got, ref)
    _close(inv, rinv)


def test_map_and_export_round_trip(ckpt):
    for gen, bg in ((ckpt["fg"], False), (ckpt["bg"], True)):
        flat = _ref_flat(gen, bg)
        jparams, jmeta = jsb.map_subj_basis_generator({k: v.numpy() for k, v in flat.items()})
        jflat = jsb.export_subj_basis_generator(jparams, bg)
        sd, meta = tsb.map_subj_basis_generator(flat)
        back = tsb.export_subj_basis_generator(sd, bg)
        assert set(jflat) == set(flat) == set(back)
        for k in flat:
            np.testing.assert_array_equal(np.asarray(jflat[k]), flat[k].numpy(), err_msg=k)
            assert torch.equal(back[k], flat[k]), k
        unread = set() if bg else {"pos_embs_ln.weight", "pos_embs_ln.bias"}
        assert set(sd) - unread == set(gen.state_dict())
        assert (meta.placeholder_is_bg, meta.output_dim, meta.num_out_embs_per_layer) == (
            jmeta.placeholder_is_bg, jmeta.output_dim, jmeta.num_out_embs_per_layer)


def test_legacy_per_feature_layer_weights_are_averaged(ckpt):
    flat = _ref_flat(ckpt["fg"], False)
    flat["hidden_state_layer_weights"] = torch.arange(3 * D, dtype=torch.float32).reshape(3, D)
    sd, meta = tsb.map_subj_basis_generator(flat)
    jparams, _ = jsb.map_subj_basis_generator({k: v.numpy() for k, v in flat.items()})
    assert meta.hidden_state_weights_were_per_feature
    _close(sd["hidden_state_layer_weights"], jparams["hidden_state_layer_weights"], 1e-5)


def test_bg_translator_output_projection_is_refused(ckpt):
    flat = tsb.export_subj_basis_generator(ckpt["bg"].state_dict(), True)
    flat["prompt_translator.to_out.0.weight"] = torch.zeros(BG_D, BG_D)
    flat["prompt_translator.to_out.2.weight"] = torch.ones(BG_D)
    flat["prompt_translator.to_out.2.bias"] = torch.zeros(BG_D)
    sd, meta = tsb.map_subj_basis_generator(flat)
    assert meta.prompt_translator_has_to_out
    assert tsb.export_subj_basis_generator(sd, True).keys() == flat.keys()
    with pytest.raises(ValueError, match="to_out"):
        tsb.load_generator(sd, meta)
