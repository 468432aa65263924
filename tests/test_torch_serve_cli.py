"""The port's serving surface against the JAX package on the CPU (tiny
configs, fp32, the same weights, the same draws passed in), images within
one uint8 level (the bar of tests/test_golden_chain.py):

- `generate` with PLMS (S + 1 UNet calls at the pair's first guidance
  value) and with `compel_cfg_weight_level`;
- `img2img` (t_enc = strength * steps, the VAE mean, a fixed guidance, the
  default negative prompt) and the JAX script's masked `inpaint` (1 =
  repaint, the empty negative prompt, annealed guidance, one fixed blend
  draw), each trap with its other choice outside the tolerance: strength
  ignored, the decode's guidance annealed, the mask inverted, the blend
  drawn from the request's seed;
- `_gt_init_code` against the JAX script's on PNGs with an fg mask;
- the three entry points at `--tiny` on the CPU, end to end: PNGs that
  read back as `generate` made them (a `--ckpt`, a reference `.pt` with
  conv attention), `--from_file` / `--n_repeat` / `--n_rows`, PLMS and
  compel, img2img and inpaint; `--compare_with` (with `--calc_face_sim`,
  `--use_first_gt_img_as_init`) scores into `scores.csv`; `--num_devices`
  / `--tp` serve over 2 gloo ranks within 1 uint8 level of one device;
  without `--device cpu` they raise on a machine without a card.

The cross-attention weights are scaled up (x10) so that the prompt, and
with it guidance and compel, move the images by more than a level."""

import csv
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from adaface_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from adaface_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from adaface_tpu.models.unet import UNetConfig as JUNetConfig
from adaface_tpu.models.unet import UNetModel as JUNet
from adaface_tpu.models.vae import AutoencoderKL as JVAE
from adaface_tpu.models.vae import VAEConfig as JVAEConfig
from adaface_tpu.ops.schedule import make_diffusion_schedule as jmake_sched
from adaface_tpu.personalization.embedding_manager import EmbeddingManager as JManager
from adaface_tpu.personalization.static_embedding import StaticEmbedderParams as JParams
from adaface_tpu.pipeline import StableDiffusionPipeline as JPipeline

import adaface_tpu_torch.pipeline as tpipe
from adaface_tpu_torch import img2img as ti2i
from adaface_tpu_torch import inpaint as tinp
from adaface_tpu_torch import txt2img as tt2i
from adaface_tpu_torch.data import png
from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.models.clip_text import CLIPTextConfig
from adaface_tpu_torch.models.unet import UNetConfig
from adaface_tpu_torch.models.vae import VAEConfig
from adaface_tpu_torch.parallel import mesh as pmesh
from adaface_tpu_torch.pipeline import StableDiffusionPipeline
from tests import torch_serve_helpers as helpers

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP_KW = dict(vocab_size=49408, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position_embeddings=77, num_extra_tokens=4)
UNET_KW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               attention_levels=(0, 1), num_heads=4, context_dim=64)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)
PROMPTS = ["a photo of a z , , person", "a z , , on the beach"]
SIZE, LAT = 32, 16


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}_script",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pipes():
    """(JAX, port) pipelines on the same weights and the same 3-vector z."""
    tok = HashTokenizer()
    tp = StableDiffusionPipeline.from_random(1, tok, UNetConfig(**UNET_KW),
                                             VAEConfig(**VAE_KW), CLIPTextConfig(**CLIP_KW),
                                             device="cpu")
    with torch.no_grad():
        for name, p in tp.unet.named_parameters():
            if ".attn2." in name:
                p.mul_(10.0)
    jtok = JHashTokenizer()
    jp = JPipeline(tokenizer=jtok, clip=JCLIP(JCLIPConfig(**CLIP_KW)),
                   clip_params=from_jax.jax_tree_from_module(tp.clip),
                   unet=JUNet(JUNetConfig(**UNET_KW)),
                   unet_params=from_jax.jax_tree_from_module(tp.unet),
                   vae=JVAE(JVAEConfig(**VAE_KW)), vae_params=from_jax.jax_tree_from_module(tp.vae),
                   embedding_manager=JManager(), base_sched=jmake_sched())
    tid = tok.add_placeholder("z")
    assert jtok.add_placeholder("z") == tid
    tp.embedding_manager.add_placeholder("z", tid, num_vectors=3, emb_dim=64, rank=4,
                                         generator=torch.Generator().manual_seed(5))
    emb = tp.embedding_manager.embedders["z"]
    jp.embedding_manager.add_placeholder("z", tid, num_vectors=3, embedder=JParams(
        *(None if f is None else jnp.asarray(f.numpy()) for f in
          (emb.basis_rand_weights, emb.basis_comm_weights, emb.basis_vecs, emb.pre_vecs,
           emb.bias))))
    return jp, tp


def _x_T(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, LAT, LAT, 4)).astype(np.float32)


def _levels(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.mark.parametrize("sampler,level", [("plms", 0.0), ("ddim", 1.0), ("plms", 2.0)])
def test_generate_plms_and_compel_equal_jax(pipes, monkeypatch, sampler, level):
    jp, tp = pipes
    kw = dict(num_steps=3, guidance_scale=(10.0, 4.0), height=SIZE, width=SIZE, x_T=_x_T(),
              sampler=sampler, compel_cfg_weight_level=level, negative_prompt="ugly")
    ref = jp.generate(PROMPTS, **kw)
    calls = []
    real = tpipe.UNetModel.forward

    def counted(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(tpipe.UNetModel, "forward", counted)
    got = tp.generate(PROMPTS, **kw)
    assert got.shape == (2, SIZE, SIZE, 3)
    assert _levels(got, ref) <= 1
    steps = 4  # a uniform stride of 3 in 1000 gives 4 steps
    assert len(calls) == steps + (sampler == "plms")
    if level:  # compel moves the images
        monkeypatch.setattr(tpipe.UNetModel, "forward", real)
        plain = tp.generate(PROMPTS, **dict(kw, compel_cfg_weight_level=0.0))
        assert _levels(plain, got) > 1


def _init_image(seed=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    img[:16] = 200  # some structure for the VAE to keep
    return img


def test_img2img_equals_jax_and_its_traps(pipes, monkeypatch):
    jp, tp = pipes
    init = _init_image()
    kw = dict(strength=0.5, num_steps=8, guidance_scale=(7.5, 2.0), seed=4)
    ref = jp.img2img(init, PROMPTS, **kw)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (2, LAT, LAT, 4)))
    got = tp.img2img(init, PROMPTS, noise=noise, **kw)
    assert _levels(got, ref) <= 1
    from adaface_tpu_torch.samplers import ddim as tddim

    def whole_run(f, s, x, i, guide_scale):
        return tddim.ddim_decode(f, s, x, 0, guide_scale)

    def annealed(f, s, x, i, guide_scale):
        b = x.shape[0]
        for j in range(i, len(s.timesteps)):
            t = torch.full((b,), int(s.timesteps[j]), dtype=torch.int32)
            x, _ = tddim.ddim_step(x, f(x, t, float(s.guidance_scales[j])), s.alphas[j],
                                   s.alphas_prev[j], s.sqrt_one_minus_alphas[j])
        return x

    # the traps: strength ignored (the decode from the first step), the
    # decode's guidance annealed
    for other in (whole_run, annealed):
        monkeypatch.setattr(tpipe, "ddim_decode", other)
        assert _levels(tp.img2img(init, PROMPTS, noise=noise, **kw), ref) > 1, other.__name__
        monkeypatch.undo()


def test_inpaint_equals_jax_and_its_traps(pipes):
    jp, tp = pipes
    init = _init_image(5)
    mask = np.zeros((SIZE, SIZE))
    mask[8:24, 4:20] = 1.0  # repaint a box
    jinpaint = _script("img2img").inpaint
    ref = jinpaint(jp, init, mask, PROMPTS, num_steps=6, guidance_scale=7.5, seed=2)
    shape = (2, LAT, LAT, 4)
    x_T = np.asarray(jax.random.normal(jax.random.PRNGKey(2), shape))
    blend = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape))
    kw = dict(num_steps=6, guidance_scale=7.5, seed=2)
    got = ti2i.inpaint(tp, init, mask, PROMPTS, x_T=x_T, blend_noise=blend, **kw)
    assert got.shape == (2, SIZE, SIZE, 3) and _levels(got, ref) <= 1
    # the region outside the mask stays the init image's
    assert _levels(got[:, :8], ref[:, :8]) <= 1
    for name, other in (("mask inverted", ti2i.inpaint(tp, init, 1.0 - mask, PROMPTS, x_T=x_T,
                                                       blend_noise=blend, **kw)),
                        ("blend drawn from the seed", ti2i.inpaint(
                            tp, init, mask, PROMPTS, x_T=x_T, blend_noise=x_T, **kw))):
        assert _levels(other, ref) > 1, name


def test_inpaint_mask_resize_is_jax_nearest():
    m = np.arange(32 * 32, dtype=np.float32).reshape(32, 32)
    ref = np.asarray(jax.image.resize(jnp.asarray(m)[None, :, :, None], (1, 4, 4, 1),
                                      "nearest"))[0, :, :, 0]
    np.testing.assert_array_equal(ti2i.resize_nearest_jax(m, 4), ref)


def test_gt_init_code_equals_jax(pipes, tmp_path):
    from types import SimpleNamespace

    from PIL import Image

    jp, tp = pipes
    folder = tmp_path / "gt"
    folder.mkdir()
    for i in range(2):
        Image.fromarray(_init_image(10 + i)).save(folder / f"{i}.png")
    mask = np.zeros((SIZE, SIZE), np.uint8)
    mask[4:20, 4:28] = 255
    Image.fromarray(mask).save(folder / "0_mask.png")
    opt = SimpleNamespace(compare_with=str(folder), size=SIZE, seed=3, n_samples=2)
    ref = _script("txt2img")._gt_init_code(opt, jp)
    got = tt2i._gt_init_code(opt, tp)
    assert got.shape == (2, LAT, LAT, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5)


# ------------------------------------------------------------- entry points

def _png_dir(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png") and f != "grid.png")


def test_txt2img_cli_end_to_end(tmp_path):
    out = tmp_path / "out"
    prompts = tmp_path / "prompts.tsv"
    prompts.write_text("2\tbeach\ta z on the beach\n1\tcity\ta z in a city\n")
    argv = ["--tiny", "--device", "cpu", "--steps", "2", "--size", "32", "--n_samples", "2",
            "--from_file", str(prompts), "--n_rows", "3", "--out", str(out),
            "--sampler", "plms", "--compel_cfg_weight_level", "1"]
    assert tt2i.main(argv) == 0
    assert _png_dir(out / "beach") == [f"{i:05}.png" for i in range(4)]
    assert _png_dir(out / "city") == ["00000.png", "00001.png"]
    assert png.read(str(out / "grid.png")).shape == (2 * 32, 3 * 32, 3)
    assert tt2i.pad_placeholders("a z person", "z", 3) == "a z , , person"
    assert tt2i.pad_placeholders("a zebra", "z", 3) == "a zebra"


def test_txt2img_cli_reads_back_as_generate(pipes, tmp_path):
    """A `--ckpt` and a reference `.pt` (static z, conv kernel size 2): the
    PNGs read back equal `generate` on the same loaded state, bit for bit."""
    _, tp = pipes
    ckpt = str(tmp_path / "sd.ckpt")
    helpers.save_ldm_checkpoint(ckpt, tp.ldm_state_dict())  # the --tiny widths
    emb = tp.embedding_manager.embedders["z"]
    pt = str(tmp_path / "embeddings_gs-10.pt")
    helpers.save_reference_embeddings(
        pt, {"z": {f: getattr(emb, f).numpy() for f in
                   ("basis_rand_weights", "basis_comm_weights", "basis_vecs", "bias")}},
        token2num={"z": 3}, conv_ks=2)
    out = tmp_path / "out"
    argv = ["--tiny", "--device", "cpu", "--ckpt", ckpt, "--embedding_paths", pt, "--steps", "2",
            "--size", "32", "--n_samples", "2", "--prompt", "a z person", "--seed", "5",
            "--out", str(out)]
    assert tt2i.main(argv) == 0
    pipe, _ = tt2i.build_pipeline(tt2i.parse_args(argv))
    assert pipe.unet.cfg.conv_attn_kernel_size == 2
    want = pipe.generate(["a z , , person"] * 2, num_steps=2, height=32, width=32, seed=5)
    got = np.stack([png.read(str(out / f)) for f in _png_dir(out)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_img2img_and_inpaint_clis(tmp_path, mode):
    init = tmp_path / "init.png"
    png.write(str(init), _init_image())
    out = tmp_path / "out"
    argv = ["--tiny", "--device", "cpu", "--steps", "4", "--size", "32", "--init_img",
            str(init), "--prompt", "a z person", "--out", str(out)]
    if mode == "inpaint":
        mask = np.zeros((32, 32), np.uint8)
        mask[8:24, 8:24] = 255
        png.write(str(tmp_path / "mask.png"), np.repeat(mask[:, :, None], 3, axis=2))
        assert tinp.main(argv + ["--mask", str(tmp_path / "mask.png")]) == 0
    else:
        assert ti2i.main(argv + ["--strength", "0.5"]) == 0
    got = [png.read(str(out / f)) for f in _png_dir(out)]
    assert len(got) == 2 and got[0].shape == (32, 32, 3)
    if mode == "inpaint":
        with pytest.raises(SystemExit, match="requires --mask"):
            tinp.main(argv)


@pytest.mark.parametrize("module,extra,item", [
    # ported: these run (None); with a reference folder the scores go to
    # scores.csv (the ids are those of the cases when they exited)
    pytest.param("txt2img", ["--compare_with", "ref"], None, id="txt2img-extra0-item 12"),
    pytest.param("txt2img", ["--calc_face_sim"], None, id="txt2img-extra1-item 12"),
    pytest.param("txt2img", ["--use_first_gt_img_as_init", "--compare_with", "ref"], None,
                 id="txt2img-extra2-item 12"),
    # ported: these serve over 2 gloo ranks (dp 2; tp 2 alone; dp 1 x tp 2),
    # rank 0 writing the samples once, within 1 uint8 level of one device
    pytest.param("txt2img", ["--num_devices", "2"], None, id="txt2img-extra3-item 13"),
    pytest.param("txt2img", ["--tp", "2"], None, id="txt2img-extra4-item 13"),
    pytest.param("img2img", ["--num_devices", "2", "--tp", "2"], None,
                 id="img2img-extra5-item 13"),
])
def test_unported_options_exit(tmp_path, module, extra, item, monkeypatch):
    # the ranks of --num_devices / --tp: a hung rank fails the test
    monkeypatch.setattr(pmesh, "launch", functools.partial(pmesh.launch, timeout=600, threads=1))
    argv = ["--tiny", "--device", "cpu", "--prompt", "a z", "--out", str(tmp_path)]
    if module == "img2img":
        argv += ["--init_img", "x.png"]
    main = {"txt2img": tt2i.main, "img2img": ti2i.main}[module]
    if item is not None:
        with pytest.raises(SystemExit, match=item):
            main(argv + extra)
        return
    if "--compare_with" not in extra and "--calc_face_sim" not in extra:
        png.write(str(tmp_path / "init.png"), _init_image())
        argv = ["--tiny", "--device", "cpu", "--steps", "2", "--size", "32", "--n_samples", "2",
                "--prompt", "a z person"]
        if module == "img2img":
            argv += ["--init_img", str(tmp_path / "init.png")]
        one, ranks = tmp_path / "one", tmp_path / "ranks"
        assert main(argv + ["--out", str(one)]) == 0
        assert main(argv + extra + ["--out", str(ranks)]) == 0
        assert _png_dir(ranks) == _png_dir(one) and len(_png_dir(one)) == 2
        for f in _png_dir(one):
            a, b = png.read(str(one / f)), png.read(str(ranks / f))
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, f
        return
    ref = tmp_path / "ref"
    ref.mkdir()
    png.write(str(ref / "0.png"), _init_image())
    out = tmp_path / "out"
    argv = ["--tiny", "--device", "cpu", "--steps", "2", "--size", "32", "--n_samples", "2",
            "--prompt", "a z person", "--out", str(out)]
    assert main(argv + [str(ref) if a == "ref" else a for a in extra]) == 0
    assert len(_png_dir(out)) == 2
    if "--compare_with" not in extra:  # nothing to score against, as in JAX
        assert not os.path.exists(out / "scores.csv")
        return
    rows = list(csv.reader(open(out / "scores.csv")))
    assert len(rows) == 1 and len(rows[0]) == 4  # prompt, CLIP-I, CLIP-T, DINO
    assert rows[0][0] == "a z person" and all(np.isfinite(float(v)) for v in rows[0][1:])


@pytest.mark.parametrize("main", [tt2i.main, ti2i.main, tinp.main])
def test_entry_points_need_the_card_unless_told(main, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--tiny", "--prompt", "a z", "--init_img", "x.png", "--mask", "m.png",
            "--out", str(tmp_path)]
    if main is tt2i.main:
        argv = ["--tiny", "--prompt", "a z", "--out", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
