"""Port parity: CLIP text encoder, UNet (with CFG stem dedup and hoisted
cross-attention K/V), VAE decoder and static subject embeddings of
`adaface_tpu_torch` against `adaface_tpu`, fp32 on the CPU. Weights are the
JAX pipeline's random init carried across by `interop.from_jax`; inputs are
numpy arrays from a seed. The bridge itself must load with strict=True and
round-trip bit-exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from adaface_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from adaface_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from adaface_tpu.models.unet import UNetConfig as JUNetConfig
from adaface_tpu.models.unet import precompute_cross_kv as j_cross_kv
from adaface_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from adaface_tpu.models.vae import VAEConfig as JVAEConfig
from adaface_tpu.personalization.embedding_manager import EmbeddingManager as JEM
from adaface_tpu.personalization.static_embedding import (
    compute_static_embedding as j_static, init_static_embedder as j_init_static)
from adaface_tpu.pipeline import StableDiffusionPipeline as JPipeline

from adaface_tpu_torch.interop import from_jax
from adaface_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel, precompute_cross_kv
from adaface_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from adaface_tpu_torch.personalization.embedding_manager import EmbeddingManager
from adaface_tpu_torch.personalization.static_embedding import compute_static_embedding

torch.set_num_threads(2)

CLIP_KW = dict(vocab_size=99, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position_embeddings=16, num_extra_tokens=3)
# level-0 self-attention at a 16x16 latent has L=256: the JAX side runs its
# Pallas kernel (interpret mode), the port its kernel's plain version
UNET_KW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               attention_levels=(0, 1), num_heads=4, context_dim=64)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)


@pytest.fixture(scope="module")
def jpipe():
    return JPipeline.from_random(jax.random.PRNGKey(0), JaxHashTokenizer(),
                                 JUNetConfig(**UNET_KW), JVAEConfig(**VAE_KW),
                                 JCLIPConfig(**CLIP_KW))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def ported(jpipe):
    return {
        "clip": _load(CLIPTextEncoder(CLIPTextConfig(**CLIP_KW)),
                      from_jax.clip_state_dict_from_jax(_np_tree(jpipe.clip_params))),
        "unet": _load(UNetModel(UNetConfig(**UNET_KW)),
                      from_jax.unet_state_dict_from_jax(_np_tree(jpipe.unet_params))),
        "vae": _load(AutoencoderKL(VAEConfig(**VAE_KW)),
                     from_jax.vae_state_dict_from_jax(_np_tree(jpipe.vae_params))),
    }


# ------------------------------------------------------------------ bridge
@pytest.mark.parametrize("name", ["clip", "unet", "vae"])
def test_bridge_round_trip_bit_exact(jpipe, ported, name):
    tree = _np_tree(getattr(jpipe, f"{name}_params"))
    back = from_jax.jax_tree_from_module(ported[name])
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a, err_msg=str(path))


def test_bridge_rejects_missing_leaf(jpipe):
    sd = from_jax.unet_state_dict_from_jax(_np_tree(jpipe.unet_params))
    sd.pop("out_conv.bias")
    with pytest.raises(RuntimeError):
        UNetModel(UNetConfig(**UNET_KW)).load_state_dict(sd, strict=True)


# -------------------------------------------------------------------- CLIP
@pytest.mark.parametrize("skip", [None, (0.5, 0.5), (1.0, 2.0, 3.0)])
def test_clip_matches(jpipe, ported, rng, skip):
    # ids over the base vocabulary plus the 3 extra placeholder rows
    ids = rng.integers(0, 99 + 3, size=(3, 16)).astype(np.int32)
    n = 2 if skip is None else len(skip)
    kw = {} if skip is None else {"skip_weights": jnp.asarray(skip)}
    ref = JCLIP(JCLIPConfig(**CLIP_KW)).apply({"params": jpipe.clip_params},
                                              jnp.asarray(ids), num_skip_layers=n, **kw)
    with torch.no_grad():
        got = ported["clip"](torch.from_numpy(ids).long(), skip_weights=skip,
                             num_skip_layers=n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_clip_embed_tokens_extra_vocab(jpipe, ported, rng):
    ids = rng.integers(90, 102, size=(2, 16)).astype(np.int32)
    ref = JCLIP(JCLIPConfig(**CLIP_KW)).apply({"params": jpipe.clip_params},
                                              jnp.asarray(ids), method=JCLIP.embed_tokens)
    with torch.no_grad():
        got = ported["clip"].embed_tokens(torch.from_numpy(ids).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -------------------------------------------------------------------- UNet
@pytest.mark.parametrize("dedup", [True, False])
def test_unet_matches(jpipe, ported, rng, dedup):
    """CFG batch of 2 (cond; uncond) at a 16x16 latent, [16, 4, 7, 64]
    context, hoisted cross K/V. atol 2e-5 on eps of order 1 (measured
    ~2e-6): fp32 conv and GEMM sums run in other orders in XLA and torch."""
    b = 2
    x = rng.standard_normal((b, 16, 16, 4)).astype(np.float32)
    t = np.array([981, 981], np.int32)
    ctx = rng.standard_normal((16, 2 * b, 7, 64)).astype(np.float32)
    x_in = x if dedup else np.concatenate([x, x])
    t_in = t if dedup else np.concatenate([t, t])
    jkv = j_cross_kv(jpipe.unet_params, jpipe.unet.cfg, jnp.asarray(ctx), dtype=jnp.float32)
    ref = jpipe.unet.apply({"params": jpipe.unet_params}, jnp.asarray(x_in),
                           jnp.asarray(t_in), jnp.asarray(ctx), cfg_dedup=dedup,
                           cross_kv=jkv)
    unet = ported["unet"]
    with torch.no_grad():
        ctx_t = torch.from_numpy(ctx)
        got = unet(torch.from_numpy(x_in), torch.from_numpy(t_in), ctx_t, cfg_dedup=dedup,
                   cross_kv=precompute_cross_kv(unet, ctx_t))
    assert got.shape == (2 * b, 16, 16, 4)
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 1e-2  # a dead UNet would pass trivially
    assert np.abs(ref[:b] - ref[b:]).max() > 1e-3  # so would a context-blind one
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_unet_separate_k_context(jpipe, ported, rng):
    """The V/K context split: keys from `context_k`, values from `context`;
    the port's hoisted K/V from both against JAX's in-loop projections."""
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([700, 40], np.int32)
    ctx, ctx_k = (rng.standard_normal((16, 2, 5, 64)).astype(np.float32) for _ in range(2))
    ref = jpipe.unet.apply({"params": jpipe.unet_params}, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(ctx), context_k=jnp.asarray(ctx_k))
    unet = ported["unet"]
    args = [torch.from_numpy(a) for a in (x, t, ctx, ctx_k)]
    with torch.no_grad():
        got = unet(*args[:3], context_k=args[3],
                   cross_kv=precompute_cross_kv(unet, args[2], args[3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_unet_cross_kv_hoist_is_exact(ported, rng):
    unet = ported["unet"]
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    t = torch.tensor([500, 20], dtype=torch.int32)
    ctx = torch.from_numpy(rng.standard_normal((16, 2, 7, 64)).astype(np.float32))
    with torch.no_grad():
        a = unet(x, t, ctx)
        b = unet(x, t, ctx, cross_kv=precompute_cross_kv(unet, ctx))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------- VAE
@pytest.mark.parametrize("hw", [8, 32])  # 32x32: mid attention is query-chunked
def test_vae_decode_matches(jpipe, ported, rng, hw):
    z = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
    ref = jpipe.vae.apply({"params": jpipe.vae_params}, jnp.asarray(z),
                          method=JAutoencoderKL.decode)
    with torch.no_grad():
        got = ported["vae"].decode(torch.from_numpy(z))
    assert got.shape == (2, 2 * hw, 2 * hw, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5)


# -------------------------------------------------------- subject embeddings
def test_static_embedding_and_patch(rng):
    jp = j_init_static(jax.random.PRNGKey(3), 16, num_vectors=3, emb_dim=64, rank=4)
    tp = from_jax.static_embedder_from_jax(jp)
    np.testing.assert_allclose(compute_static_embedding(tp).numpy(),
                               np.asarray(j_static(jp)), atol=1e-5)

    ids = np.array([[5, 7, 200, 9, 9, 1], [200, 3, 4, 5, 200, 6]], np.int32)
    jm, tm = JEM(), EmbeddingManager()
    jm.add_placeholder("z", token_id=200, num_vectors=3, embedder=jp)
    tm.add_placeholder("z", token_id=200, num_vectors=3, embedder=tp)
    sm = tm.build_slot_maps(ids)
    np.testing.assert_array_equal(sm["z"], jm.build_slot_maps(ids)["z"])
    emb = rng.standard_normal((2, 6, 64)).astype(np.float32)
    ref = JEM.patch_prompt_embeddings(jnp.asarray(emb), sm, {"z": j_static(jp)})
    got = EmbeddingManager.patch_prompt_embeddings(
        torch.from_numpy(emb), sm, {"z": compute_static_embedding(tp)})
    assert got.shape == (16, 2, 6, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
