"""SD v1.x checkpoints in the port, against the JAX package on the CPU, tiny
configs, fp32: the LDM-name maps of the UNet, VAE and CLIP (the JAX maps'
trees run the JAX forwards; the port's state dicts the port's forwards, on
the same numpy inputs; tolerance 5e-5), the inverse maps' round trip, the
strictness of the maps, the two containers (a torch zip `.ckpt` holding an
object of an unknown class, read without running pickled code, and a
`.safetensors`), and `from_sd_checkpoint` against JAX's (its SD v1.5
configs patched to the tiny ones): the fresh placeholder rows of the CLIP
table bit for bit, including the trap of their seed, and `generate` within
one uint8 level. No full-width load: the suite runs six workers on one
CPU."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adaface_tpu.interop.hf_clip as jhf
from adaface_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from adaface_tpu.interop import torch_pickle as jtp
from adaface_tpu.interop.sd_unet import map_unet_params
from adaface_tpu.interop.sd_vae import map_vae_params
from adaface_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from adaface_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from adaface_tpu.models.unet import UNetConfig as JUNetConfig
from adaface_tpu.models.unet import UNetModel as JUNet
from adaface_tpu.models.vae import AutoencoderKL as JVAE
from adaface_tpu.models.vae import VAEConfig as JVAEConfig
from adaface_tpu.pipeline import StableDiffusionPipeline as JPipeline

from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.interop import sd_unet, sd_vae, torch_pickle
from adaface_tpu_torch.interop.hf_clip import map_clip_text_state_dict
from adaface_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from adaface_tpu_torch.pipeline import StableDiffusionPipeline, build_random
from tests import torch_serve_helpers as helpers

torch.set_num_threads(2)

ATOL = 5e-5
CLIP_KW = dict(vocab_size=49408, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position_embeddings=77)
UNET_KW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               attention_levels=(0, 1), num_heads=4, context_dim=64)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)
CLIP_PREFIX = "cond_stage_model.transformer.text_model."
PROMPTS = ["a photo of a z , , person", "a cat"]


def _np(sd):
    return {k: v.detach().float().numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def port_pipe():
    """A random tiny port pipeline with 8 placeholder rows."""
    return StableDiffusionPipeline.from_random(
        3, HashTokenizer(), UNetConfig(**UNET_KW), VAEConfig(**VAE_KW),
        CLIPTextConfig(**CLIP_KW, num_extra_tokens=8), device="cpu")


@pytest.fixture(scope="module")
def ldm_sd(port_pipe):
    return port_pipe.ldm_state_dict()


def test_unet_map_matches_jax_forward(port_pipe, ldm_sd):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([10, 900], np.int32)
    ctx = rng.standard_normal((1, 2, 77, 64)).astype(np.float32)
    params = map_unet_params(_np(ldm_sd), JUNetConfig(**UNET_KW))
    ref = JUNet(JUNetConfig(**UNET_KW)).apply({"params": params}, jnp.asarray(x),
                                               jnp.asarray(t), jnp.asarray(ctx))
    unet = UNetModel(UNetConfig(**UNET_KW))
    unet.load_state_dict(sd_unet.map_unet_state_dict(ldm_sd, unet.cfg), strict=True)
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_vae_map_matches_jax_forward(ldm_sd):
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    params = map_vae_params(_np(ldm_sd), JVAEConfig(**VAE_KW))
    jvae = JVAE(JVAEConfig(**VAE_KW))
    ref_mean, _ = jvae.apply({"params": params}, jnp.asarray(img), method=JVAE.encode)
    ref_img = jvae.apply({"params": params}, jnp.asarray(z), method=JVAE.decode)
    vae = AutoencoderKL(VAEConfig(**VAE_KW))
    vae.load_state_dict(sd_vae.map_vae_state_dict(ldm_sd, vae.cfg), strict=True)
    with torch.no_grad():
        mean, _ = vae.encode(torch.from_numpy(img))
        dec = vae.decode(torch.from_numpy(z))
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean), atol=ATOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref_img), atol=ATOL)


def test_clip_map_matches_jax_forward(ldm_sd):
    ids = np.asarray(HashTokenizer()(PROMPTS))
    params = jhf.map_clip_text_params(_np(ldm_sd), num_layers=2, prefix=CLIP_PREFIX)
    ref = JCLIP(JCLIPConfig(**CLIP_KW)).apply({"params": params}, jnp.asarray(ids),
                                              skip_weights=jnp.asarray([0.5, 0.5]))
    clip = CLIPTextEncoder(CLIPTextConfig(**CLIP_KW))
    clip.load_state_dict(map_clip_text_state_dict(ldm_sd, 2, prefix=CLIP_PREFIX), strict=True)
    with torch.no_grad():
        got = clip(torch.from_numpy(ids).long(), skip_weights=(0.5, 0.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("part", ["unet", "vae"])
def test_inverse_map_round_trip_and_strictness(port_pipe, part):
    mod, m, fwd, inv = {"unet": (port_pipe.unet, sd_unet, "map_unet_state_dict",
                                 "ldm_unet_state_dict"),
                        "vae": (port_pipe.vae, sd_vae, "map_vae_state_dict",
                                "ldm_vae_state_dict")}[part]
    sd = mod.state_dict()
    ldm = getattr(m, inv)(sd, mod.cfg)
    back = getattr(m, fwd)(ldm, mod.cfg)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    extra = dict(ldm)
    extra[next(iter(ldm)).rsplit(".", 2)[0] + ".unexpected.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="not consumed"):
        getattr(m, fwd)(extra, mod.cfg)
    missing = dict(ldm)
    missing.pop(next(iter(ldm)))
    with pytest.raises(KeyError, match="missing"):
        getattr(m, fwd)(missing, mod.cfg)


@pytest.mark.parametrize("suffix,dtype", [(".ckpt", torch.float32), (".ckpt", torch.float16),
                                          (".safetensors", torch.bfloat16)])
def test_containers_load_without_running_code(ldm_sd, tmp_path, suffix, dtype):
    path = str(tmp_path / f"sd{suffix}")
    helpers.save_ldm_checkpoint(path, ldm_sd, dtype)
    helpers.RAN.clear()
    got = torch_pickle.load_sd_state_dict(path)
    assert not helpers.RAN  # nothing pickled was executed
    assert set(got) == set(ldm_sd)
    for k, v in ldm_sd.items():
        assert got[k].dtype == dtype and torch.equal(got[k], v.to(dtype)), k
    ref = jtp.load_sd_state_dict(path)  # JAX's reader: bf16 widened to fp32
    for k in ("model.diffusion_model.out.2.weight", CLIP_PREFIX + "final_layer_norm.bias"):
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(ref[k], np.float32))
    if suffix == ".ckpt":
        whole = torch_pickle.load_torch_checkpoint(path)
        cb = whole["callbacks"]["ModelCheckpoint"]
        assert isinstance(cb, torch_pickle.TorchObjectStub) and whole["global_step"] == 7
        assert cb.__dict__["_stub_qualname"].endswith("._must_not_run")
        assert cb.__dict__["_stub_args"] == (("callback",), {})  # recorded, not called


def test_nested_module_tree_is_walked(ldm_sd, tmp_path):
    """A checkpoint whose top level is a pickled module (no flat state
    dict): `walk_stub_tree` names its tensors as `state_dict()` would."""
    flat = {k: v for k, v in ldm_sd.items() if k.startswith("first_stage_model.")}
    with helpers.reference_modules():
        mod = helpers.module_from_flat(helpers.StaticLayerwiseEmbedding, flat, tag="x")
        path = str(tmp_path / "module.pt")
        torch.save(mod, path)
    tree = torch_pickle.load_torch_checkpoint(path)
    walked = torch_pickle.walk_stub_tree(tree)
    assert set(walked) == set(flat)
    assert all(torch.equal(walked[k], flat[k]) for k in flat)


def _patch_jax_sd_v1(monkeypatch):
    """JAX's `from_sd_checkpoint` builds SD v1.5 configs and a 12-layer CLIP
    map: point them at the tiny ones."""
    monkeypatch.setattr(JUNetConfig, "sd_v1", classmethod(lambda cls, **kw: cls(**UNET_KW)))
    monkeypatch.setattr(JVAEConfig, "sd_v1", classmethod(lambda cls, **kw: cls(**VAE_KW)))
    monkeypatch.setattr(JCLIPConfig, "vit_l_14",
                        classmethod(lambda cls, **kw: cls(**{**CLIP_KW, **kw})))
    monkeypatch.setattr(jhf, "map_clip_text_params",
                        functools.partial(jhf.map_clip_text_params, num_layers=2))


def _load_both(monkeypatch, path):
    _patch_jax_sd_v1(monkeypatch)
    jp = JPipeline.from_sd_checkpoint(path, JHashTokenizer())
    tp = StableDiffusionPipeline.from_sd_checkpoint(
        path, HashTokenizer(), device="cpu", unet_cfg=UNetConfig(**UNET_KW),
        vae_cfg=VAEConfig(**VAE_KW), clip_cfg=CLIPTextConfig(**CLIP_KW))
    return jp, tp


@pytest.mark.parametrize("suffix,dtype", [(".ckpt", torch.float32), (".ckpt", torch.float16),
                                          (".safetensors", torch.bfloat16)])
def test_extra_token_rows_equal_jax_bit_for_bit(monkeypatch, ldm_sd, tmp_path, suffix, dtype):
    path = str(tmp_path / f"sd{suffix}")
    helpers.save_ldm_checkpoint(path, ldm_sd, dtype)
    jp, tp = _load_both(monkeypatch, path)
    ref = np.asarray(jp.clip_params["extra_token_embedding"]["embedding"], np.float32)
    got = tp.clip.extra_token_embedding.weight.detach().numpy()
    assert got.shape == (8, 64)
    np.testing.assert_array_equal(got, ref)
    # the trap: rows from another seed, or the std of the rows themselves,
    # are other numbers
    base = tp.clip.token_embedding.weight.detach().numpy()
    other = np.random.default_rng(1).standard_normal((8, 64)).astype(np.float32) * base.std()
    assert np.abs(other - got).max() > 0.5 * base.std()
    want = sd_unet.map_unet_state_dict(ldm_sd, tp.unet.cfg)
    for k, v in tp.unet.state_dict().items():
        assert torch.equal(v, want[k].to(dtype).float()), k


def test_from_sd_checkpoint_generates_as_jax(monkeypatch, ldm_sd, tmp_path):
    path = str(tmp_path / "sd.ckpt")
    helpers.save_ldm_checkpoint(path, ldm_sd)
    jp, tp = _load_both(monkeypatch, path)
    x_T = np.random.default_rng(0).standard_normal((2, 16, 16, 4)).astype(np.float32)
    kw = dict(num_steps=2, height=32, width=32, x_T=x_T, negative_prompt="ugly")
    ref = jp.generate(PROMPTS, **kw)
    got = tp.generate(PROMPTS, **kw)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_from_sd_checkpoint_refuses_cpu_fallback(ldm_sd, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "sd.safetensors")
    helpers.save_ldm_checkpoint(path, ldm_sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StableDiffusionPipeline.from_sd_checkpoint(path, HashTokenizer())
