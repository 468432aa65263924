"""Port parity of every knob arm of the flash-attention dispatch: the packed
entry (`forward_arm`: einsum, K1, K2, K4, K5, the CROSS pad, K1's EXP_BF16
and MXU_SUM arithmetic) and the `[B, H, L, D]` entry (`bhld_arm`: einsum,
K6, K7, HOST_PAD read as the unpadded function), each against the JAX package with its Pallas kernels in
interpret mode, and the tiny UNet's attention routing under the knobs.

Which TPU kernel JAX takes is read by spies on its kernel bodies
(`adaface_tpu.ops.flash_attention._flash_kernel_heads_pvt` etc. are looked up
at call time, so nothing in JAX changes); the port's `forward_arm` /
`bhld_arm` must name the same one, and its entry must dispatch on it.

Tolerances, no looser than the JAX tests' own for each arm: outputs 2e-5
(MXU_SUM 3e-5, EXP_BF16 3e-2, whose bf16 roundings can flip on a one-ulp
difference between XLA's and torch's exp2), gradients 3e-5 (the JAX
cross-attention gradient test's bar), UNet eps 2e-5. fp32 throughout."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.models.unet import UNetModel as JUNetModel
from adaface_tpu.ops import flash_attention as jfa
from adaface_tpu_torch.models.unet import UNetConfig, UNetModel
from adaface_tpu_torch.ops import flash_attention as tfa

from test_torch_train_step import UNET_KW, pipes  # noqa: F401

torch.set_num_threads(2)
ATOL, GRAD_ATOL = 2e-5, 3e-5
JAX_KERNELS = {"_flash_kernel_heads_pvt": "K1", "_flash_kernel_heads_pvt2": "K2",
               "_flash_kernel_heads_short": "K4", "_flash_kernel_heads": "K5",
               "_flash_kernel": "K6", "_flash_row_kernel": "K7"}
FLASH_KNOBS = ("ADAFACE_FLASH_CROSS", "ADAFACE_FLASH_MAXFREE", "ADAFACE_FLASH_PVT",
               "ADAFACE_FLASH_PVT2", "ADAFACE_FLASH_SHORT", "ADAFACE_FLASH_EXP_BF16",
               "ADAFACE_FLASH_MXU_SUM", "ADAFACE_FLASH_MODE", "ADAFACE_FLASH_HOST_PAD",
               "ADAFACE_FLASH_BWD", "ADAFACE_FLASH_PACKED", "ADAFACE_FLASH_PACKED_MIN_L",
               "ADAFACE_FLASH_MIN_LK")


@pytest.fixture
def knobs(monkeypatch):
    """Clear every flash knob, then set the ones a test passes."""
    for name in FLASH_KNOBS:
        monkeypatch.delenv(name, raising=False)

    def set_knobs(values):
        for k, v in values.items():
            monkeypatch.setenv(k, v)
    return set_knobs


@pytest.fixture
def jax_seen(monkeypatch):
    """The TPU kernel ids whose bodies JAX traced."""
    seen = set()
    for name, kid in JAX_KERNELS.items():
        real = getattr(jfa, name)

        def spy(*a, _r=real, _k=kid, **kw):
            seen.add(_k)
            return _r(*a, **kw)

        monkeypatch.setattr(jfa, name, spy)
    return seen


@pytest.fixture
def port_arms(monkeypatch):
    """The arms the port's entries hand to their kernel path."""
    arms = []
    real = tfa._flash

    def spy(q, k, v, key_bias, num_heads, scale, arm, flags):
        arms.append(tfa.arm_id(arm, flags))
        return real(q, k, v, key_bias, num_heads, scale, arm, flags)

    monkeypatch.setattr(tfa, "_flash", spy)
    return arms


def _packed(rng, b, lq, lk, width):
    return [rng.standard_normal((b, l, width)).astype(np.float32) for l in (lq, lk, lk)]


# (knobs, Lq, Lk) -> the TPU kernel JAX takes ("einsum": none)
PACKED_CASES = [
    ({}, 512, 512, "K1"),
    ({}, 256, 256, "K4"),
    ({}, 512, 77, "einsum"),
    ({}, 128, 512, "einsum"),
    ({"ADAFACE_FLASH_PVT2": "1", "ADAFACE_FLASH_SHORT": "0"}, 256, 256, "K2"),
    ({"ADAFACE_FLASH_PVT2": "1"}, 512, 512, "K2"),
    ({"ADAFACE_FLASH_SHORT": "0"}, 256, 256, "K2"),
    ({"ADAFACE_FLASH_SHORT": "0", "ADAFACE_FLASH_PVT2": "0"}, 256, 256, "K1"),
    ({"ADAFACE_FLASH_SHORT": "0"}, 512, 256, "K1"),
    ({"ADAFACE_FLASH_MAXFREE": "0"}, 512, 512, "K5"),
    ({"ADAFACE_FLASH_MAXFREE": "0"}, 256, 256, "K5"),
    ({"ADAFACE_FLASH_PVT": "0"}, 512, 512, "K5"),
    ({"ADAFACE_FLASH_PVT": "0"}, 256, 256, "K4"),
    ({"ADAFACE_FLASH_CROSS": "1"}, 512, 77, "K4"),
    ({"ADAFACE_FLASH_CROSS": "1"}, 256, 77, "K4"),
    ({"ADAFACE_FLASH_CROSS": "1", "ADAFACE_FLASH_MAXFREE": "0"}, 256, 77, "K5"),
    ({"ADAFACE_FLASH_CROSS": "1", "ADAFACE_FLASH_SHORT": "0"}, 512, 77, "K1"),
    ({"ADAFACE_FLASH_CROSS": "1"}, 128, 77, "einsum"),
]


@pytest.mark.parametrize("env,lq,lk,want", PACKED_CASES)
def test_packed_arm_matches_jax_kernel(knobs, jax_seen, port_arms, rng, env, lq, lk, want):
    knobs(env)
    heads, d = 2, 40
    q, k, v = _packed(rng, 1, lq, lk, heads * d)
    ref = jfa.flash_attention_blc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    got = tfa.flash_attention_blc(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), heads)
    assert jax_seen == (set() if want == "einsum" else {want})
    assert tfa.forward_arm(lq, lk) == want
    assert port_arms == ([] if want == "einsum" else [want])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


BHLD_CASES = [
    ({}, 256, 256, "K6"),
    ({}, 512, 128, "einsum"),
    ({"ADAFACE_FLASH_MODE": "row"}, 256, 512, "K7"),
    ({"ADAFACE_FLASH_MODE": "row"}, 384, 256, "K6"),  # 384 % 256 != 0
    ({"ADAFACE_FLASH_MODE": "row", "ADAFACE_FLASH_HOST_PAD": "1"}, 256, 256, "K7"),
    ({"ADAFACE_FLASH_HOST_PAD": "1"}, 256, 256, "K6"),
]


@pytest.mark.parametrize("env,lq,lk,want", BHLD_CASES)
def test_bhld_arm_matches_jax_kernel(knobs, jax_seen, port_arms, rng, env, lq, lk, want):
    """The [B, H, L, D] entry with a key bias (a fully masked batch row):
    the arm, and the output of the one-head fold against JAX (under
    HOST_PAD=1 JAX pads the head dim to 128; the port's unpadded fold computes
    the same function)."""
    knobs(env)
    b, heads, d = 2, 2, 40
    q = rng.standard_normal((b, heads, lq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, heads, lk, d)).astype(np.float32) for _ in range(2))
    bias = np.where(rng.random((b, lk)) > 0.3, 0.0, -1e30).astype(np.float32)
    bias[0] = -1e30
    ref = jfa.flash_attention(*(jnp.asarray(t) for t in (q, k, v, bias)))
    got = tfa.flash_attention(*(torch.from_numpy(t) for t in (q, k, v, bias)))
    assert jax_seen == (set() if want == "einsum" else {want})
    assert tfa.bhld_arm(lq, lk) == want
    assert port_arms == ([] if want == "einsum" else [want])
    assert got.shape == (b, heads, lq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def _grads_vs_jax(jfn, tfn, arrays, w, n_diff):
    """jax.grad of <f(...), w> against the port's autograd, for the first
    n_diff arrays; returns (jax grads, port grads)."""
    ja = [jnp.asarray(a) for a in arrays]
    ref = jax.grad(lambda *xs: jnp.sum(jfn(*xs, *ja[n_diff:]) * jnp.asarray(w)),
                   argnums=tuple(range(n_diff)))(*ja[:n_diff])
    ta = [torch.from_numpy(a) for a in arrays]
    for t in ta[:n_diff]:
        t.requires_grad_(True)
    (tfn(*ta) * torch.from_numpy(w)).sum().backward()
    return ref, [t.grad for t in ta[:n_diff]]


@pytest.mark.parametrize("env", [{"ADAFACE_FLASH_CROSS": "1"},
                                 {"ADAFACE_FLASH_CROSS": "1", "ADAFACE_FLASH_MAXFREE": "0"},
                                 {"ADAFACE_FLASH_CROSS": "1", "ADAFACE_FLASH_BWD": "einsum"}])
def test_cross_pad_output_and_gradients(knobs, rng, env):
    """CROSS=1 at Lk 77: k/v padded to 128 with zero rows under a -1e30 bias.
    A fully masked batch row averages over all 128 keys (the 51 zero rows
    included), not over the 77 real ones; dq, dk, dv and dbias (sliced back
    to 77) match jax.grad."""
    knobs(env)
    heads, d, lq, lk = 2, 40, 256, 77
    q, k, v = _packed(rng, 2, lq, lk, heads * d)
    bias = np.where(rng.random((2, lk)) > 0.3, 0.0, -1e30).astype(np.float32)
    bias[1] += rng.standard_normal(lk).astype(np.float32)
    bias[0] = -1e30
    w = rng.standard_normal((2, lq, heads * d)).astype(np.float32)
    jf = lambda q_, k_, v_, b_: jfa.flash_attention_blc(q_, k_, v_, heads, key_bias=b_)
    tf = lambda q_, k_, v_, b_: tfa.flash_attention_blc(q_, k_, v_, heads, key_bias=b_)
    out = tf(*(torch.from_numpy(a) for a in (q, k, v, bias))).numpy()
    np.testing.assert_allclose(out, np.asarray(jf(*(jnp.asarray(a) for a in (q, k, v, bias)))),
                               atol=ATOL)
    np.testing.assert_allclose(out[0], np.broadcast_to(v[0].sum(0) / 128, out[0].shape),
                               atol=ATOL)
    assert np.abs(out[0] - v[0].mean(0)).max() > 1e-2  # the unpadded average differs
    ref, got = _grads_vs_jax(jf, tf, [q, k, v, bias], w, 4)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, err_msg=name)


def test_cross_pad_without_bias_floors_every_score(knobs, rng):
    """CROSS=1 with no key bias: the pad makes a zero bias, so every score
    is floored at -100 (log2) as in JAX; gradients without dbias."""
    knobs({"ADAFACE_FLASH_CROSS": "1"})
    heads, d = 2, 40
    q, k, v = _packed(rng, 1, 256, 77, heads * d)
    q, k = np.abs(q) * 100.0, -np.abs(k)  # every score below the floor
    w = rng.standard_normal((1, 256, heads * d)).astype(np.float32)
    jf = lambda q_, k_, v_: jfa.flash_attention_blc(q_, k_, v_, heads)
    tf = lambda q_, k_, v_: tfa.flash_attention_blc(q_, k_, v_, heads)
    out = tf(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jf(*(jnp.asarray(a) for a in (q, k, v)))),
                               atol=ATOL)
    unfloored = tfa.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)), heads)
    assert (out - unfloored).abs().max() > 1e-2
    # uniform over the 128 padded keys
    np.testing.assert_allclose(out.numpy()[0], np.broadcast_to(v[0].sum(0) / 128,
                                                               out.shape[1:]), atol=ATOL)
    ref, got = _grads_vs_jax(jf, tf, [q, k, v], w, 3)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, err_msg=name)


class _ExactExp2:
    """`jnp` with exp2 evaluated in fp32 and rounded to the input's dtype."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp2(x):
        return jnp.exp2(x.astype(jnp.float32)).astype(x.dtype)


@pytest.mark.parametrize("env,want,atol", [
    ({"ADAFACE_FLASH_MXU_SUM": "1"}, "K1+mxu_sum", 3e-5),
    ({"ADAFACE_FLASH_EXP_BF16": "1"}, "K1+exp_bf16", 3e-2),
    ({"ADAFACE_FLASH_EXP_BF16": "1", "ADAFACE_FLASH_MXU_SUM": "1"},
     "K1+exp_bf16+mxu_sum", 3e-2),
])
def test_k1_arithmetic_arms(knobs, jax_seen, port_arms, monkeypatch, rng, env, want, atol):
    """K1's arms against JAX. XLA lowers `jnp.exp2` of a bf16 array as
    exp(bf16(x * 0.69140625)), ln 2 rounded to bf16: 2^(0.9975 x), up to 12%
    off at |x| ~ 30. The port takes exp2 of bf16(s) exactly, so EXP_BF16 is
    held at the JAX test's own 3e-2 against JAX as it lowers, and at 2e-5
    against JAX with its exp2 evaluated in fp32 and rounded."""
    knobs(env)
    heads, d, l = 2, 40, 512
    q, k, v = _packed(rng, 2, l, l, heads * d)
    bias = np.where(rng.random((2, l)) > 0.3, 0.0, -1e30).astype(np.float32)
    jax_out = lambda: np.asarray(jfa.flash_attention_blc(
        *(jnp.asarray(a) for a in (q, k, v)), heads, key_bias=jnp.asarray(bias)))
    ref = jax_out()
    got = tfa.flash_attention_blc(*(torch.from_numpy(a) for a in (q, k, v)), heads,
                                  key_bias=torch.from_numpy(bias)).numpy()
    assert jax_seen == {"K1"} and port_arms == [want]
    np.testing.assert_allclose(got, ref, atol=atol)
    if "ADAFACE_FLASH_EXP_BF16" in env:
        monkeypatch.setattr(jfa, "jnp", _ExactExp2())
        np.testing.assert_allclose(got, jax_out(), atol=ATOL)
        default = tfa.flash_attention_blc_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                                heads, torch.from_numpy(bias)).numpy()
        assert np.abs(default - got).max() > 1e-4  # not the default function


def test_k1_flags_do_not_reach_other_arms(knobs, port_arms, rng):
    """EXP_BF16 and MXU_SUM belong to K1 only: at L256 (K4) the function is
    the default one."""
    knobs({"ADAFACE_FLASH_EXP_BF16": "1", "ADAFACE_FLASH_MXU_SUM": "1"})
    q, k, v = (torch.from_numpy(a) for a in _packed(rng, 1, 256, 256, 80))
    got = tfa.flash_attention_blc(q, k, v, 2)
    assert port_arms == ["K4"]
    torch.testing.assert_close(got, tfa.flash_attention_blc_plain(q, k, v, 2), rtol=0, atol=0)


@pytest.mark.parametrize("env", [{}, {"ADAFACE_FLASH_MODE": "row"},
                                 {"ADAFACE_FLASH_HOST_PAD": "1"},
                                 {"ADAFACE_FLASH_BWD": "einsum"}])
def test_bhld_gradients_through_the_fold(knobs, rng, env):
    """dq, dk, dv and dbias of the [B, H, L, D] entry (the bias repeated per
    head in the fold, its gradient summed back over heads) against
    jax.grad through JAX's `flash_attention`."""
    knobs(env)
    b, heads, l, d = 2, 2, 256, 40
    q, k, v, w = (rng.standard_normal((b, heads, l, d)).astype(np.float32) for _ in range(4))
    bias = np.where(rng.random((b, l)) > 0.3, 0.0, -1e30).astype(np.float32)
    bias[1] += rng.standard_normal(l).astype(np.float32)
    ref, got = _grads_vs_jax(lambda *a: jfa.flash_attention(*a),
                             lambda *a: tfa.flash_attention(*a), [q, k, v, bias], w, 4)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, err_msg=name)


def test_einsum_backward_arm_of_the_packed_entry(knobs, rng):
    """BWD=einsum differentiates the einsum reference, bias included: no
    floor, so a masked key gets no bias gradient, unlike the flash
    backward."""
    knobs({"ADAFACE_FLASH_BWD": "einsum"})
    heads, d, l = 2, 40, 256
    q, k, v = _packed(rng, 2, l, l, heads * d)
    bias = np.where(rng.random((2, l)) > 0.3, 0.0, -1e30).astype(np.float32)
    w = rng.standard_normal((2, l, heads * d)).astype(np.float32)
    jf = lambda q_, k_, v_, b_: jfa.flash_attention_blc(q_, k_, v_, heads, key_bias=b_)
    tf = lambda q_, k_, v_, b_: tfa.flash_attention_blc(q_, k_, v_, heads, key_bias=b_)
    ref, got = _grads_vs_jax(jf, tf, [q, k, v, bias], w, 4)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL, err_msg=name)
    assert np.abs(got[3].numpy()[bias < -1]).max() == 0.0


def test_cuda_wrapper_refuses_flags_on_padded_head_dims():
    """The kernel is built for the UNet's head dims only: HOST_PAD's padded
    head dim 128 is refused, with K1's flags or without."""
    q = torch.zeros((1, 256, 128))
    for flags in (tfa.FLAG_MXU_SUM, 0):
        with pytest.raises(ValueError, match="head dims"):
            tfa.flash_attention_blc_cuda(q, q, q, 1, flags=flags)


# ------------------------------------------------------------ tiny UNet
def _unet_inputs(rng):
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([981, 120], np.int32)
    ctx = rng.standard_normal((16, 2, 7, 64)).astype(np.float32)
    mask = np.ones((2, 16, 16, 1), np.float32)
    mask[0, :, 11:] = 0.0
    mask[1, 3:9, 2:12] = 0.0
    return x, t, ctx, mask


# (knobs, config fields) -> the arms the port hands to the kernel path; the
# tiny UNet attends at L256 (level 0, d 8) and L64 (level 1, d 16) with 7
# context tokens
UNET_CASES = [
    ({"ADAFACE_FLASH_PACKED": "0"}, {}, {"K6"}),
    ({"ADAFACE_FLASH_CROSS": "1"}, {}, {"K4"}),
    ({}, {"fuse_qkv": True}, {"K4"}),
    ({}, {"use_flash_attention": False}, set()),
    ({"ADAFACE_FLASH_MIN_LK": "100", "ADAFACE_FLASH_PACKED_MIN_L": "512"}, {}, {"K6"}),
]


@pytest.mark.parametrize("env,fields,arms", UNET_CASES)
def test_tiny_unet_attention_arms_match_jax(knobs, pipes, port_arms, rng, env, fields, arms):
    """The tiny UNet with an img_mask (self-attention key mask) under a knob
    combination or config field, against JAX's UNet with the same weights."""
    knobs(env)
    jp, tp = pipes
    junet = JUNetModel(jp.unet.cfg.replace(**fields))
    unet = UNetModel(UNetConfig(**UNET_KW, **fields))
    unet.load_state_dict(tp.unet.state_dict(), strict=True)
    x, t, ctx, mask = _unet_inputs(rng)
    ref = np.asarray(junet.apply({"params": jp.unet_params}, *(jnp.asarray(a) for a in
                                                                (x, t, ctx)),
                                 img_mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = unet(*(torch.from_numpy(a) for a in (x, t, ctx)),
                   img_mask=torch.from_numpy(mask)).numpy()
    assert set(port_arms) == arms
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_unet_config_defaults_match_jax():
    from adaface_tpu.models.unet import UNetConfig as JUNetConfig

    jc, tc = JUNetConfig(), UNetConfig()
    assert (tc.use_flash_attention, tc.fuse_qkv) == (jc.use_flash_attention, jc.fuse_qkv)
    assert dataclasses.replace(tc, fuse_qkv=True).fuse_qkv
