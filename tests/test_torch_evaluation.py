"""Port parity of the evaluation stack, fp32 on the CPU: `models/vit.py`,
`evaluation/{scorers,eval_utils,prompt_sets}.py` and the HF CLIP maps
against the JAX package's.

- The ViT: a tiny JAX `ViTEncoder` carried over by `interop/from_jax.py`
  gives the same hidden states within 1e-5 of the largest value; an HF
  `ViTModel` state dict (transformers, 2 layers) read by the port's
  `map_vit_state_dict` matches HF's own forward at 3e-5 (JAX's test's
  tolerance); `preprocess_vit_images` matches JAX's at 1e-6.
- The scorers on tiny towers carried over from JAX: CLIP-I, CLIP-T and
  text-text similarities at every reduction (`mean`, `diag`, `diagmean`,
  `none`), `evaluate`, and DINO's, within 1e-5.
- `init_evaluators` on env-pointed files (`CLIP_SCORER_PT`: an HF
  `CLIPModel` state dict; `DINO_VITS16_PT`: an HF `ViTModel`, both made with
  transformers at tiny widths, 12 layers, the scorer configs patched to them
  in both packages): the same scores as JAX's within 1e-5, and JAX's
  warning about real CLIP weights with hash token ids. Without files: the
  random tiny towers score images of any size.
- `compare_folders` and `compare_face_folders` on PNG folders (the port
  decodes them with its own codec, JAX with PIL) on carried-over scorers
  and recognizers, a faceless image among them: within 1e-5, the no-face
  counts equal.
- `parse_subject_file`, `parse_range_str`, `find_first_match`,
  `list_image_files` and `get_prompt_list` equal to JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.data.tokenizer import HashTokenizer as JTok
from adaface_tpu.evaluation import eval_utils as jeu
from adaface_tpu.evaluation import prompt_sets as jps
from adaface_tpu.evaluation import scorers as jsc
from adaface_tpu.face_app import FaceApp as JFaceApp
from adaface_tpu.models import clip_text as jct
from adaface_tpu.models import clip_vision as jcv
from adaface_tpu.models import vit as jvit

from adaface_tpu_torch.data import png
from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.evaluation import eval_utils as teu
from adaface_tpu_torch.evaluation import prompt_sets as tps
from adaface_tpu_torch.evaluation import scorers as tsc
from adaface_tpu_torch.face_app import FaceApp
from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.models import clip_text as tct
from adaface_tpu_torch.models import clip_vision as tcv
from adaface_tpu_torch.models import vit as tvit

from test_torch_face_stack import _jax_iresnet, _port_iresnet

torch.set_num_threads(2)

TOL = 1e-5
REDUCTIONS = ("mean", "diag", "diagmean", "none")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(m, sd):
    m.load_state_dict(sd, strict=True)
    return m.eval()


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=tol * max(np.abs(ref).max(), 1e-30), rtol=0)


def _images(seed, n, h=40, w=36):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


# -------------------------------------------------------------------- ViT

def test_vit_carried_over_matches_jax():
    cfg = jvit.ViTConfig.tiny()
    enc = jvit.ViTEncoder(cfg)
    p = _np_tree(enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    rng = np.random.default_rng(1)
    p = jax.tree_util.tree_map(lambda a: (a + 0.1 * rng.standard_normal(a.shape))
                               .astype(np.float32), p)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(enc.apply({"params": p}, jnp.asarray(x)))
    port = _load(tvit.ViTEncoder(tvit.ViTConfig.tiny()), from_jax.state_dict_from_jax(p))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), ref)
    imgs = _images(2, 3, 50, 45)
    _close(tvit.preprocess_vit_images(torch.from_numpy(imgs), 32),
           jvit.preprocess_vit_images(jnp.asarray(imgs), 32), 1e-6)


def test_vit_map_matches_hf():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.ViTModel(transformers.ViTConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        image_size=32, patch_size=16), add_pooling_layer=False).eval()
    port = _load(tvit.ViTEncoder(tvit.ViTConfig.tiny()),
                 tvit.map_vit_state_dict(hf.state_dict(), num_layers=2))
    px = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = hf(pixel_values=torch.from_numpy(px).permute(0, 3, 1, 2)).last_hidden_state
        got = port(torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-5)
    assert tvit.hf_vit_state_dict(port.state_dict(), 2).keys() <= hf.state_dict().keys()


# ---------------------------------------------------------------- scorers

@pytest.fixture(scope="module")
def scorers():
    """(JAX CLIPScorer, DINOScorer), (the port's), on the same tiny towers
    and projections."""
    jtok = JTok()
    text = jct.CLIPTextEncoder(jct.CLIPTextConfig.tiny(vocab_size=jtok.vocab_size,
                                                       max_position_embeddings=77))
    tp = _np_tree(text.init(jax.random.PRNGKey(0),
                            input_ids=jnp.zeros((1, 77), jnp.int32))["params"])
    vis = jcv.CLIPVisionEncoder(jcv.CLIPVisionConfig.tiny())
    vp = _np_tree(vis.init(jax.random.PRNGKey(1), jnp.zeros((1, 28, 28, 3)))["params"])
    vit = jvit.ViTEncoder(jvit.ViTConfig.tiny())
    dp = _np_tree(vit.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))["params"])
    rng = np.random.default_rng(0)
    tproj = rng.standard_normal((64, 32)).astype(np.float32)
    vproj = rng.standard_normal((64, 32)).astype(np.float32)
    jclip = jsc.CLIPScorer(jtok, text, tp, vis, vp, tproj, vproj)
    tclip = tsc.CLIPScorer(
        HashTokenizer(),
        _load(tct.CLIPTextEncoder(tct.CLIPTextConfig.tiny(vocab_size=jtok.vocab_size,
                                                          max_position_embeddings=77)),
              from_jax.clip_state_dict_from_jax(tp)),
        _load(tcv.CLIPVisionEncoder(tcv.CLIPVisionConfig.tiny()),
              from_jax.vision_state_dict_from_jax(vp)),
        torch.from_numpy(tproj), torch.from_numpy(vproj))
    tdino = tsc.DINOScorer(_load(tvit.ViTEncoder(tvit.ViTConfig.tiny()),
                                 from_jax.state_dict_from_jax(dp)))
    return (jclip, jsc.DINOScorer(vit, dp)), (tclip, tdino)


TEXTS = ["a photo of a dog", "a red car on the street", "a portrait of a person"]


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_clip_scorer_matches_jax(scorers, reduction):
    (jclip, _), (tclip, _) = scorers
    a, b = _images(3, 3), _images(4, 3, 64, 48)
    _close(tclip.image_pairwise_similarity(a, b, reduction),
           jclip.image_pairwise_similarity(a, b, reduction))
    _close(tclip.txt_to_img_similarity(TEXTS, b, reduction),
           jclip.txt_to_img_similarity(TEXTS, b, reduction))
    _close(tclip.txt_to_img_similarity(TEXTS[0], b, reduction),
           jclip.txt_to_img_similarity(TEXTS[0], b, reduction))
    _close(tclip.text_pairwise_similarity(TEXTS, TEXTS[::-1], reduction),
           jclip.text_pairwise_similarity(TEXTS, TEXTS[::-1], reduction))


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_dino_scorer_matches_jax(scorers, reduction):
    (_, jdino), (_, tdino) = scorers
    a, b = _images(5, 2), _images(6, 3, 30, 50)
    _close(tdino.image_pairwise_similarity(a, b, reduction),
           jdino.image_pairwise_similarity(a, b, reduction))


def test_clip_evaluate_matches_jax(scorers):
    (jclip, _), (tclip, _) = scorers
    gen, ref = _images(7, 4), _images(8, 2)
    for got, want in zip(tclip.evaluate(gen, ref, TEXTS[1]), jclip.evaluate(gen, ref, TEXTS[1])):
        _close(got, want)


# ------------------------------------------------------- init_evaluators

def _hf_files(tmp_path):
    """An HF CLIPModel and an HF ViTModel state dict at tiny widths (12
    layers, as the maps' defaults read), saved with torch.save."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(1)
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=49408, hidden_size=64, intermediate_size=128,
                         num_attention_heads=4, num_hidden_layers=12,
                         max_position_embeddings=77),
        vision_config=dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                           num_hidden_layers=12, image_size=64, patch_size=32),
        projection_dim=32)
    clip_path, dino_path = str(tmp_path / "clip.pt"), str(tmp_path / "dino.pt")
    torch.save(transformers.CLIPModel(cfg).state_dict(), clip_path)
    torch.save(transformers.ViTModel(transformers.ViTConfig(
        hidden_size=64, num_hidden_layers=12, num_attention_heads=4, intermediate_size=128,
        image_size=32, patch_size=16), add_pooling_layer=False).state_dict(), dino_path)
    return clip_path, dino_path


def _patch_tiny_configs(monkeypatch):
    vis = dict(hidden_size=64, num_layers=12, num_heads=4, intermediate_size=128,
               image_size=64, patch_size=32)
    for mod in (jcv, tcv):
        monkeypatch.setattr(mod.CLIPVisionConfig, "vit_b_32",
                            classmethod(lambda cls, **kw: cls(**vis)))
    for mod in (jvit, tvit):
        monkeypatch.setattr(mod.ViTConfig, "dino_vits16",
                            classmethod(lambda cls, **kw: cls.tiny(num_layers=12)))
    real = jct.CLIPTextConfig
    monkeypatch.setattr(jsc, "CLIPTextConfig", lambda **kw: real(
        **dict(kw, hidden_size=64, num_heads=4, intermediate_size=128)))
    monkeypatch.setattr(tsc, "clip_b32_text_config", lambda **kw: tct.CLIPTextConfig(
        hidden_size=64, num_heads=4, intermediate_size=128, **kw))


def test_init_evaluators_reads_env_files_like_jax(tmp_path, monkeypatch):
    clip_path, dino_path = _hf_files(tmp_path)
    _patch_tiny_configs(monkeypatch)
    monkeypatch.setenv("CLIP_SCORER_PT", clip_path)
    monkeypatch.setenv("DINO_VITS16_PT", dino_path)
    for k in ("CLIP_VOCAB_JSON", "CLIP_MERGES_TXT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.warns(UserWarning, match="HashTokenizer over real weights"):
        jclip, jdino = jsc.init_evaluators()
    with pytest.warns(UserWarning, match="HashTokenizer over real weights"):
        tclip, tdino = tsc.init_evaluators(device="cpu")
    assert tclip.vision.cfg.num_layers == 12 and tclip.text_projection.shape == (64, 32)
    gen, ref = _images(9, 3), _images(10, 2, 70, 70)
    for got, want in zip(tclip.evaluate(gen, ref, TEXTS[2]), jclip.evaluate(gen, ref, TEXTS[2])):
        _close(got, want)
    _close(tdino.image_pairwise_similarity(gen, ref, "none"),
           jdino.image_pairwise_similarity(gen, ref, "none"))


def test_init_evaluators_without_files(monkeypatch):
    for k in ("CLIP_SCORER_PT", "DINO_VITS16_PT"):
        monkeypatch.delenv(k, raising=False)
    clip, dino = tsc.init_evaluators(device="cpu")
    assert clip.vision.cfg == tcv.CLIPVisionConfig.tiny() and clip.visual_projection.shape == (64, 32)
    rng = np.random.default_rng(0)
    for proj in (clip.text_projection, clip.visual_projection):  # JAX's draws, in its order
        np.testing.assert_array_equal(proj.numpy(),
                                      rng.standard_normal((64, 32)).astype(np.float32))
    sims = clip.txt_to_img_similarity(TEXTS, _images(11, 3, 20, 30), "diag")
    assert sims.shape == (3,) and torch.isfinite(sims).all()
    assert float(dino.image_pairwise_similarity(_images(12, 2), _images(13, 2))) <= 1 + 1e-6


# --------------------------------------------------------------- folders

def _write_folder(path, seed, n, faceless=()):
    path.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.integers(0, 256, (48, 44, 3), dtype=np.uint8)
        if i in faceless:
            img[:] = 7  # the stub detector finds no face in a flat image
        png.write(str(path / f"{i:03}.png"), img)
    png.write(str(path / "000_mask.png"), np.full((48, 44), 255, np.uint8))
    png.write(str(path / "grid.png"), np.zeros((8, 8, 3), np.uint8))
    return str(path)


def _detector(image):
    from adaface_tpu.face_app import full_image_detector

    return [] if image.std() == 0 else full_image_detector(image)


def test_compare_folders_match_jax(scorers, tmp_path):
    (jclip, jdino), (tclip, tdino) = scorers
    gen = _write_folder(tmp_path / "gen", 1, 4, faceless=(2,))
    gt = _write_folder(tmp_path / "gt", 2, 3)
    assert teu.list_image_files(gen) == jeu.list_image_files(gen) and len(
        teu.list_image_files(gen)) == 4
    np.testing.assert_array_equal(teu.load_image_folder(gen, size=32),
                                  jeu.load_image_folder(gen, size=32))
    for self_cmp in (False, True):
        got = teu.compare_folders(tclip, tdino, gen, gt, TEXTS[0], gt_self_compare=self_cmp)
        want = jeu.compare_folders(jclip, jdino, gen, gt, TEXTS[0], gt_self_compare=self_cmp)
        _close(np.asarray(got), np.asarray(want))
    got = teu.compare_folders(tclip, tdino, gen, gt, TEXTS[0], num_samples=2)
    want = jeu.compare_folders(jclip, jdino, gen, gt, TEXTS[0], num_samples=2)
    _close(np.asarray(got), np.asarray(want))

    model, p = _jax_iresnet(16, seed=3)
    japp = JFaceApp(model, p, detect_fn=_detector)
    tapp = FaceApp(_port_iresnet(p, 16), detect_fn=_detector)
    for max_images in (None, 3):
        sim, nf1, nf2 = teu.compare_face_folders(tapp.embed_image, gen, gt, max_images)
        jsim, jnf1, jnf2 = jeu.compare_face_folders(japp.embed_image, gen, gt, max_images)
        assert (nf1, nf2) == (jnf1, jnf2) == (1, 0)
        np.testing.assert_allclose(sim, jsim, atol=TOL)
    empty = tmp_path / "empty"
    empty.mkdir()
    png.write(str(empty / "0.png"), np.full((8, 8, 3), 7, np.uint8))
    assert teu.compare_face_folders(tapp.embed_image, str(empty), gt) == \
        jeu.compare_face_folders(japp.embed_image, str(empty), gt) == (0.0, 1, 0)


# ------------------------------------------------------------- subject files

def test_subject_file_and_ranges_match_jax(tmp_path):
    path = tmp_path / "info.sh"
    path.write_text(
        "# subjects\n"
        "set -g subjects alice bob rex\n"
        "set -g class_names \"woman\" 'man' \"dog\"\n"
        "set -g cls_delta_strings \"young woman\" \"young man\" \"corgi dog\"\n"
        "set -g data_folder subjects\n"
        "set -g are_faces 1 1 0\n"
        "set -g maxiters 2000 2000 1500\n"
        "set -g all_init_word_weights \"1 2\" \"1 1\" \"3 1\"\n"
        "set -g bg_init_strings $class_names\n"
        "set -g sel_set 1 3\n")
    assert teu.parse_subject_file(str(path)) == jeu.parse_subject_file(str(path))
    info, attr = teu.parse_subject_file(str(path))
    assert info["sel_set"] == [0, 2] and info["broad_classes"] == [1, 1, 1]
    assert attr["bg_init_strings"]["bob"] == "man"
    bad = tmp_path / "bad.sh"
    bad.write_text("set -g subjects a b\nset -g class_names x\n"
                   "set -g cls_delta_strings x y\nset -g data_folder d\n")
    for mod in (teu, jeu):
        with pytest.raises(ValueError, match="class_names has 1 values"):
            mod.parse_subject_file(str(bad))
    for s, fix in (("3-7,8,10", True), ("1,2-4", False), (None, True), ("5", True)):
        assert teu.parse_range_str(s, fix) == jeu.parse_range_str(s, fix)
    items = ["logs/alice-2024", "logs/bob-2024-ada", "logs/bob-2023"]
    for term, sig in (("bob", ""), ("bob", "ada"), ("carl", ""), ("2024", "alice")):
        assert teu.find_first_match(items, term, sig) == jeu.find_first_match(items, term, sig)


@pytest.mark.parametrize("broad_class,set_name", [(0, "all"), (1, "dreambench"),
                                                  (1, "community"), (2, "all")])
def test_prompt_lists_match_jax(broad_class, set_name):
    args = ("z", "face portrait of", ", cinematic", " with background y", "person",
            "young person", broad_class, set_name)
    assert tps.get_prompt_list(*args) == jps.get_prompt_list(*args)
    assert len(tps.get_prompt_list(*args)[0]) > 20
    with pytest.raises(ValueError):
        tps.get_prompt_list(*args[:6], 1, "other")
