"""Port parity: the flash-attention backward of `adaface_tpu_torch` on the CPU
(the kernels' plain versions `row_lse_plain` and `flash_backward_plain`, and
the `FlashAttentionBLC` autograd path) against the JAX package's
`_flash_backward` (Pallas in interpret mode) and `jax.grad` through its
`flash_attention_blc`. fp32; atol 2e-5 on outputs of order 0.01..1 (the
same bar as the forward's parity tests: fp32 sums in other orders). The
CUDA kernels are held against the same plain versions on the card by
`chip_smoke.py`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.ops import flash_attention as jfa
from adaface_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)
ATOL = 2e-5


def _case(rng, b, l, heads, d, bias_kind):
    q, k, v, do = (rng.standard_normal((b, l, heads * d)).astype(np.float32)
                   for _ in range(4))
    bias = None
    if bias_kind == "masked":
        bias = np.where(rng.random((b, l)) > 0.3, 0.0, -1e30).astype(np.float32)
        bias[0] = -1e30  # a fully masked batch row: every score floored
    return q, k, v, do, bias


def _bhld(x, heads):
    b, l, w = x.shape
    return jnp.asarray(x).reshape(b, l, heads, w // heads).transpose(0, 2, 1, 3)


def _blc(x):
    x = np.asarray(x)
    b, h, l, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, l, h * d)


@pytest.mark.parametrize("bias_kind", [None, "masked"])
@pytest.mark.parametrize("l,heads,d", [(256, 4, 8), (256, 2, 40), (512, 2, 80),
                                       (512, 4, 40)])
def test_plain_backward_matches_jax_flash_backward(rng, l, heads, d, bias_kind):
    b = 2
    q, k, v, do, bias = _case(rng, b, l, heads, d, bias_kind)
    scale = d ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tb = None if bias is None else torch.from_numpy(bias)
    o = tfa.flash_attention_blc_plain(tq, tk, tv, heads, tb, scale)
    lse = tfa.row_lse_plain(tq, tk, heads, tb, scale)
    assert lse.shape == (b, heads, l)
    got = tfa.flash_backward_plain(tq, tk, tv, tb, o, tdo, lse, heads, scale)
    ref = jfa._flash_backward(_bhld(q, heads), _bhld(k, heads), _bhld(v, heads),
                              None if bias is None else jnp.asarray(bias),
                              _bhld(o.numpy(), heads), _bhld(do, heads), scale)
    for name, g, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), _blc(r), atol=ATOL, err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=ATOL,
                               err_msg="dbias per head")
    if bias is not None:
        # the floor is not differentiated away: a fully masked row still
        # has a nonzero bias gradient, as in the TPU kernel
        assert np.abs(got[3][0].numpy()).max() > 1e-4


def test_row_lse_is_log2_sum_exp(rng):
    b, l, heads, d = 2, 256, 2, 40
    q, k, _, _, _ = _case(rng, b, l, heads, d, None)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    lse = tfa.row_lse_plain(tq, tk, heads)
    qh, kh = (t.reshape(b, l, heads, d).transpose(1, 2) for t in (tq, tk))
    nat = torch.logsumexp(qh @ kh.transpose(-1, -2) * d ** -0.5, dim=-1)
    np.testing.assert_allclose(lse.numpy(), (nat / np.log(2)).numpy(), atol=1e-5)
    # with every key masked, the floor makes it log2(Lk) - 100
    full = torch.full((b, l), -1e30)
    np.testing.assert_allclose(tfa.row_lse_plain(tq, tk, heads, full).numpy(),
                               np.full((b, heads, l), np.log2(l) - 100.0), atol=1e-4)


@pytest.mark.parametrize("bias_kind", [None, "masked"])
@pytest.mark.parametrize("l,heads,d", [(256, 2, 40), (512, 2, 8)])
def test_autograd_matches_jax_grad(rng, l, heads, d, bias_kind):
    """dq, dk, dv (and the bias gradient) of a scalar loss <o, w> through the
    port's flash_attention_blc against jax.grad through JAX's."""
    b = 2
    q, k, v, w, bias = _case(rng, b, l, heads, d, bias_kind)
    if bias is not None:  # a finite part too, so the bias gradient is not trivial
        bias = bias + rng.standard_normal(bias.shape).astype(np.float32)

    def jloss(q_, k_, v_, bias_):
        o = jfa.flash_attention_blc(q_, k_, v_, heads, key_bias=bias_)
        return jnp.sum(o * jnp.asarray(w))

    args = [jnp.asarray(x) for x in (q, k, v)]
    if bias is None:
        ref = jax.grad(lambda a, b_, c: jloss(a, b_, c, None), argnums=(0, 1, 2))(*args)
    else:
        ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(*args, jnp.asarray(bias))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    out = tfa.flash_attention_blc(tq, tk, tv, heads, key_bias=tb)
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=ATOL, err_msg=name)
    if bias is not None:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(ref[3]), atol=ATOL)


def test_autograd_gradcheck_fp64(rng):
    """torch.autograd.gradcheck of the CPU path in fp64 (the plain backward
    against finite differences of the plain forward), a finite bias whose
    scores stay above the floor."""
    b, l, heads, d = 1, 256, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((b, l, heads * d)) * 0.5)
               .requires_grad_(True) for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((b, l))).requires_grad_(True)
    fn = lambda q_, k_, v_, b_: tfa.flash_attention_blc(q_, k_, v_, heads, key_bias=b_)
    # fast mode: the Jacobian-vector product along random directions
    assert torch.autograd.gradcheck(fn, (q, k, v, bias), eps=1e-6, atol=1e-6, rtol=1e-4,
                                    fast_mode=True)


def test_inference_takes_no_autograd_path(rng):
    """Without a tensor that needs a gradient the forward runs alone (no
    lse); with one, the result is the same."""
    b, l, heads, d = 1, 256, 2, 40
    q, k, v = (torch.from_numpy(rng.standard_normal((b, l, heads * d)).astype(np.float32))
               for _ in range(3))
    plain = tfa.flash_attention_blc(q, k, v, heads)
    assert plain.grad_fn is None
    qq = q.clone().requires_grad_(True)
    out = tfa.flash_attention_blc(qq, k, v, heads)
    assert type(out.grad_fn).__name__ == "FlashAttentionBLCBackward"
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)


def test_cuda_backward_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 256, 320), dtype=torch.bfloat16)
    lse = torch.zeros((1, 8, 256))
    with pytest.raises(ValueError):
        tfa.flash_backward_cuda(q, q, q, None, q, q, lse, 8)
