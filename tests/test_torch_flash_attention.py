"""Port parity: `adaface_tpu_torch.ops.flash_attention` on the CPU (the
kernel's plain version) against the JAX `flash_attention_blc`, whose Pallas
kernels run in interpret mode here. fp32, atol 2e-5 (the JAX tests' bar).

Shapes: L256 is where JAX takes `_flash_kernel_heads_short` (K4), L512 and
L1024 where it takes `_flash_kernel_heads_pvt` (K1). The CUDA kernel itself
is held against the same plain version on the card by `chip_smoke.py`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaface_tpu.ops import flash_attention as jfa
from adaface_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)
ATOL = 2e-5


def _inputs(rng, b, lq, lk, width):
    return [rng.standard_normal((b, l, width)).astype(np.float32) for l in (lq, lk, lk)]


@pytest.mark.parametrize("l,heads,d", [(256, 8, 40), (256, 4, 160), (512, 8, 80),
                                       (1024, 2, 40)])
def test_packed_matches_jax(rng, l, heads, d):
    q, k, v = _inputs(rng, 2, l, l, heads * d)
    ref = jfa.flash_attention_blc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    got = tfa.flash_attention_blc(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), heads)
    assert got.dtype == torch.float32 and got.shape == (2, l, heads * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_fused_qkv_input(rng):
    b, l, heads, d = 2, 256, 8, 40
    qkv = rng.standard_normal((b, l, 3 * heads * d)).astype(np.float32)
    ref = jfa.flash_attention_qkv(jnp.asarray(qkv), heads)
    got = tfa.flash_attention_qkv(torch.from_numpy(qkv), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("l", [256, 512])
def test_key_bias_fully_masked_row_uniform(rng, l):
    b, heads, d = 2, 4, 40
    q, k, v = _inputs(rng, b, l, l, heads * d)
    bias = np.zeros((b, l), np.float32)
    bias[0] = -1e30                        # every key of row 0 masked
    bias[1, rng.random(l) > 0.7] = -1e30   # a partial mask on row 1
    ref = jfa.flash_attention_blc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                  key_bias=jnp.asarray(bias))
    got = tfa.flash_attention_blc(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), heads,
                                  key_bias=torch.from_numpy(bias)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
    # the masked row is the uniform average of the values
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(0), got[0].shape),
                               atol=ATOL)


@pytest.mark.parametrize("lq,lk", [(64, 64), (256, 77), (100, 300)])
def test_short_sequences_take_einsum_path(rng, lq, lk):
    b, heads, d = 2, 4, 40
    q, k, v = _inputs(rng, b, lq, lk, heads * d)
    bias = np.where(rng.random((b, lk)) > 0.2, 0.0, -1e30).astype(np.float32)
    tfa.launches_by_shape.clear()
    ref = jfa.flash_attention_blc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                  key_bias=jnp.asarray(bias))
    got = tfa.flash_attention_blc(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), heads, key_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    assert not tfa.launches_by_shape


def test_plain_version_matches_reference_attention(rng):
    # the kernel's log2-domain function equals the natural-log softmax
    b, l, heads, d = 2, 64, 2, 40
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, b, l, l, heads * d))
    np.testing.assert_allclose(tfa.flash_attention_blc_plain(q, k, v, heads).numpy(),
                               tfa.reference_attention(q, k, v, heads).numpy(), atol=ATOL)


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    q = torch.zeros((1, 256, 320))
    with pytest.raises(ValueError):
        tfa.flash_attention_blc_cuda(q, q, q, 8)
    with pytest.raises(ValueError):
        tfa.flash_attention_blc_cuda(torch.zeros((1, 256, 64)), q, q, 2)  # d = 32
