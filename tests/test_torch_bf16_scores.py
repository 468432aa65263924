"""Attention scores are fp32 products in bf16, as in the JAX package.

JAX asks for the score product `q . k` in fp32
(`preferred_element_type=float32`) in `_reference_attention`, the CLIP
attention and the VAE mid attention. A bf16 product rounded afterwards
puts ~0.4% relative error into every score; with scores of std ~6 the
softmax turns that into ~1e-2 relative L2 error on the output (measured on
the CPU: 6.7e-3 CLIP, 8.9e-3 einsum attention, 9.1e-3 / 1.4e-2 VAE). With
fp32 products the port agrees with JAX to <= 4.2e-4, so the limit here is
1e-3. bf16 inputs and weights on the CPU, the same for both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaface_tpu.models import clip_text as jclip
from adaface_tpu.models import vae as jvae
from adaface_tpu.ops import flash_attention as jfa

from adaface_tpu_torch.interop.from_jax import state_dict_from_jax
from adaface_tpu_torch.models import clip_text as tclip
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)
REL_TOL = 1e-3
W = 64
SIGMA = (6 / W) ** 0.5  # projection std that gives scores of std ~6


def _rel(got, ref, base=0.0):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return np.linalg.norm(got - ref) / np.linalg.norm(ref - base)


def _bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def test_reference_attention_bf16_scores(rng):
    b, lq, lk, h, d = 2, 256, 77, 8, 40
    q, k = ((rng.standard_normal((b, l, h * d)) * 6 ** 0.5).astype(np.float32)
            for l in (lq, lk))
    v = rng.standard_normal((b, lk, h * d)).astype(np.float32)
    split = lambda x: x.reshape(b, -1, h, d).transpose(0, 2, 1, 3)
    ref = jfa._reference_attention(split(_bf16(q)), split(_bf16(k)), split(_bf16(v)),
                                   None, d ** -0.5)
    ref = jnp.asarray(ref).transpose(0, 2, 1, 3).reshape(b, lq, h * d)
    got = tfa.reference_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), h)
    assert _rel(got, ref) <= REL_TOL


def _dense(rng, i, o, s):
    return {"kernel": (rng.standard_normal((i, o)) * s).astype(np.float32),
            "bias": np.zeros(o, np.float32)}


def test_clip_attention_bf16_scores(rng):
    params = {"q_proj": _dense(rng, W, W, SIGMA), "k_proj": _dense(rng, W, W, SIGMA),
              "v_proj": _dense(rng, W, W, W ** -0.5), "out_proj": _dense(rng, W, W, W ** -0.5)}
    x = rng.standard_normal((2, 77, W)).astype(np.float32)
    jcfg = jclip.CLIPTextConfig.tiny(hidden_size=W, num_heads=4, max_position_embeddings=77)
    causal = jnp.tril(jnp.ones((77, 77), bool))[None, None]
    ref = jclip.CLIPAttention(jcfg, dtype=jnp.bfloat16).apply({"params": params},
                                                               _bf16(x), causal)
    m = tclip.CLIPAttention(tclip.CLIPTextConfig.tiny(hidden_size=W, num_heads=4))
    m.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = m.bfloat16()(torch.from_numpy(x).bfloat16(),
                           torch.ones((77, 77), dtype=torch.bool).tril())
    assert _rel(got, ref) <= REL_TOL


@pytest.mark.parametrize("hw", [8, 32])  # 32x32: the query-chunked path
def test_vae_attn_block_bf16_scores(rng, hw):
    conv = lambda s: {"kernel": (rng.standard_normal((1, 1, W, W)) * s).astype(np.float32),
                      "bias": np.zeros(W, np.float32)}
    params = {"norm_scale": np.ones(W, np.float32), "norm_bias": np.zeros(W, np.float32),
              "q": conv(SIGMA), "k": conv(SIGMA), "v": conv(W ** -0.5),
              "proj_out": conv(W ** -0.5)}
    x = rng.standard_normal((2, hw, hw, W)).astype(np.float32)
    ref = jvae.AttnBlock(dtype=jnp.bfloat16).apply({"params": params}, _bf16(x))
    m = tvae.AttnBlock(W)
    m.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = m.bfloat16()(torch.from_numpy(x).bfloat16())
    # the error of the attention branch, not of the residual it is added to
    x_bf16 = torch.from_numpy(x).bfloat16().float().numpy()
    assert _rel(got, ref, base=x_bf16) <= REL_TOL
