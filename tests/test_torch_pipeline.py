"""Port parity end to end: `generate(x_T=...)` of both packages with one
tiny configuration, 2 DDIM steps, annealed CFG and a spliced 3-vector
subject placeholder, fp32 on the CPU, same weights (through the bridge) and
the same initial noise. The uint8 images must agree within 1 level, the bar
of tests/test_golden_chain.py. Also: the port's entry points refuse to fall
back to the CPU silently."""

import numpy as np
import pytest
import torch

import jax

from adaface_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from adaface_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from adaface_tpu.models.unet import UNetConfig as JUNetConfig
from adaface_tpu.models.vae import VAEConfig as JVAEConfig
from adaface_tpu.pipeline import StableDiffusionPipeline as JPipeline

from adaface_tpu_torch.data.tokenizer import HashTokenizer
from adaface_tpu_torch.device import resolve_device
from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from adaface_tpu_torch.ops import flash_attention as tfa
from adaface_tpu_torch.pipeline import StableDiffusionPipeline

torch.set_num_threads(2)

CLIP_KW = dict(vocab_size=49408, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position_embeddings=77, num_extra_tokens=4)
UNET_KW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               attention_levels=(0, 1), num_heads=4, context_dim=64)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)
PROMPTS = ["a photo of a z , , person", "a photo of a z , , person", "a cat"]


def _pipelines():
    jtok = JaxHashTokenizer()
    jp = JPipeline.from_random(jax.random.PRNGKey(1), jtok, JUNetConfig(**UNET_KW),
                               JVAEConfig(**VAE_KW), JCLIPConfig(**CLIP_KW))
    tid = jtok.add_placeholder("z")
    jp.embedding_manager.add_placeholder("z", token_id=tid, num_vectors=3,
                                         init_key=jax.random.PRNGKey(5), emb_dim=64, rank=4)

    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    clip = CLIPTextEncoder(CLIPTextConfig(**CLIP_KW))
    clip.load_state_dict(from_jax.clip_state_dict_from_jax(tree(jp.clip_params)), strict=True)
    unet = UNetModel(UNetConfig(**UNET_KW))
    unet.load_state_dict(from_jax.unet_state_dict_from_jax(tree(jp.unet_params)), strict=True)
    vae = AutoencoderKL(VAEConfig(**VAE_KW))
    vae.load_state_dict(from_jax.vae_state_dict_from_jax(tree(jp.vae_params)), strict=True)
    tok = HashTokenizer()
    tp = StableDiffusionPipeline(tok, clip, unet, vae)
    assert tok.add_placeholder("z") == tid
    tp.embedding_manager.add_placeholder(
        "z", token_id=tid, num_vectors=3,
        embedder=from_jax.static_embedder_from_jax(jp.embedding_manager.embedders["z"]))
    return jp, tp


def test_tokenizer_copy_gives_identical_ids():
    jt, tt = JaxHashTokenizer(), HashTokenizer()
    assert jt.add_placeholder("z") == tt.add_placeholder("z")
    np.testing.assert_array_equal(jt(PROMPTS + ["Ünïcode, words & 123"]),
                                  tt(PROMPTS + ["Ünïcode, words & 123"]))


def test_generate_matches_jax_within_one_level():
    jp, tp = _pipelines()
    x_T = np.random.default_rng(0).standard_normal((3, 16, 16, 4)).astype(np.float32)
    kw = dict(num_steps=2, guidance_scale=(10.0, 4.0), height=32, width=32, x_T=x_T,
              negative_prompt="ugly, blurry")
    ref = jp.generate(PROMPTS, **kw)
    tfa.launches_by_shape.clear()
    got = tp.generate(PROMPTS, **kw)
    assert got.shape == (3, 32, 32, 3) and got.dtype == np.uint8
    assert not tfa.launches_by_shape  # CPU tensors take the plain version, never the kernel
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert got.std() > 1  # not a constant image


@pytest.mark.parametrize("knob", [None, "ADAFACE_CFG_DEDUP", "ADAFACE_CROSS_KV"])
def test_generate_knob_arms_match_jax(monkeypatch, knob):
    """`ADAFACE_CFG_DEDUP=0` (the UNet at batch 2B, no stem dedup) and
    `ADAFACE_CROSS_KV=0` (no cross-K/V hoist), read per `generate` call as
    JAX reads them: the port under the knob against JAX under the same knob,
    within 1 uint8 level as above. Spies on the port's UNet and on
    `precompute_cross_kv` show which arm ran."""
    import adaface_tpu_torch.pipeline as tpipe

    for name in ("ADAFACE_CFG_DEDUP", "ADAFACE_CROSS_KV"):
        monkeypatch.delenv(name, raising=False)
    if knob is not None:
        monkeypatch.setenv(knob, "0")
    jp, tp = _pipelines()
    calls, hoists = [], []
    tp.unet.register_forward_pre_hook(
        lambda mod, args, kwargs: calls.append(
            (args[0].shape[0], kwargs["cfg_dedup"], kwargs["cross_kv"] is not None)),
        with_kwargs=True)
    real = tpipe.precompute_cross_kv
    monkeypatch.setattr(tpipe, "precompute_cross_kv",
                        lambda *a, **k: hoists.append(1) or real(*a, **k))
    x_T = np.random.default_rng(0).standard_normal((3, 16, 16, 4)).astype(np.float32)
    kw = dict(num_steps=2, guidance_scale=(10.0, 4.0), height=32, width=32, x_T=x_T,
              negative_prompt="ugly, blurry")
    ref = jp.generate(PROMPTS, **kw)
    got = tp.generate(PROMPTS, **kw)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    dedup, hoist = knob != "ADAFACE_CFG_DEDUP", knob != "ADAFACE_CROSS_KV"
    assert calls == [(3 if dedup else 6, dedup, hoist)] * 2  # 2 DDIM steps, B = 3
    assert len(hoists) == (1 if hoist else 0)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StableDiffusionPipeline.from_random(0, HashTokenizer(), UNetConfig.tiny(),
                                            VAEConfig.tiny(), CLIPTextConfig.tiny())
    pipe = StableDiffusionPipeline.from_random(
        0, HashTokenizer(), UNetConfig(**UNET_KW), VAEConfig(**VAE_KW),
        CLIPTextConfig(**CLIP_KW), device="cpu")
    imgs = pipe.generate(["a cat"], num_steps=1, height=16, width=16, seed=3)
    assert imgs.shape == (1, 16, 16, 3)
    np.testing.assert_array_equal(
        imgs, pipe.generate(["a cat"], num_steps=1, height=16, width=16, seed=3))
