"""The port's Upsample against the JAX package's (`ops/subpixel.py`): the
phase fold `upsample2x_conv` (JAX's default) and the naive
`nearest_upsample2x_conv_reference` (JAX under `ADAFACE_SUBPIXEL_UP=0`),
the knob's dispatch in the UNet's and the VAE's `Upsample`, on the CPU from
numpy inputs made from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.models import unet as junet
from adaface_tpu.models import vae as jvae
from adaface_tpu.ops import subpixel as jsub
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.ops import subpixel as tsub

torch.set_num_threads(2)
# fp32: the fold and JAX's fold sum the same products in other orders
FP32_ATOL = 2e-5
# bf16: the port's default must sit closer to JAX's default than this share
# of the gap between JAX's default and JAX's naive path (the folded taps
# rounded to bf16 make that gap; the accumulation order alone makes the
# port's distance)
BF16_GAP_SHARE = 0.5


def _inputs(seed, b=2, h=6, w=5, c=32, co=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) / np.sqrt(9 * c)).astype(np.float32)  # HWIO
    bias = rng.standard_normal(co).astype(np.float32)
    return x, k, bias


def _torch_w(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_fp32_matches_jax_forward_and_gradients(seed):
    x, k, bias = _inputs(seed)
    g = np.random.default_rng(seed + 100).standard_normal((2, 12, 10, 24)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x_, k_: jsub.upsample2x_conv(x_, k_, jnp.asarray(bias)),
                       jnp.asarray(x), jnp.asarray(k))
    dx_ref, dk_ref = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = _torch_w(k).requires_grad_(True)
    got = tsub.upsample2x_conv(xt, wt, torch.from_numpy(bias))
    assert got.shape == (2, 12, 10, 24)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=FP32_ATOL)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), atol=FP32_ATOL)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(dk_ref),
                               atol=FP32_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_default_bf16_is_jax_default(seed):
    """In bf16 the fold's pre-summed taps round to bf16: the port's default
    must be JAX's default, not the naive function."""
    x, k, bias = _inputs(seed, c=64, co=64)
    xb, kb, bb = (jnp.asarray(a, jnp.bfloat16) for a in (x, k, bias))
    jax_default = jsub.upsample2x_conv(xb, kb, bb)
    jax_naive = jsub.nearest_upsample2x_conv_reference(xb, kb, bb)
    got = tsub.upsample2x_conv(torch.from_numpy(x).bfloat16(), _torch_w(k).bfloat16(),
                               torch.from_numpy(bias).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (2, 12, 10, 64)
    gap = _rel(_np(jax_naive), _np(jax_default))
    dist = _rel(_np(got), _np(jax_default))
    assert gap > 0, "bf16 folding changed nothing: the check cannot tell the paths apart"
    assert dist < BF16_GAP_SHARE * gap, (dist, gap)


@pytest.mark.parametrize("c", [640, 1280])
def test_bf16_default_sits_as_far_from_fp32_as_jax_default(c):
    """At the UNet's Upsample widths (8x8, one image): the port's bf16
    default departs from the fp32 function of the same bf16-rounded weights
    and input as far as JAX's bf16 default does, and further than JAX's
    bf16 naive path, by the folded taps' rounding; against the same
    function with the taps folded in bf16 and the rest in fp32 (the port's
    fold of an fp32 input with a bf16 weight, chip_smoke's phase 8
    reference) both defaults sit as close as the naive path sits to fp32."""
    x, k, bias = _inputs(5 + c, b=1, h=8, w=8, c=c, co=c)
    xb, kb, bb = (jnp.asarray(a, jnp.bfloat16) for a in (x, k, bias))
    xr, kr, br = (np.array(_np(a)) for a in (xb, kb, bb))
    fp32 = _np(jsub.nearest_upsample2x_conv_reference(jnp.asarray(xr), jnp.asarray(kr),
                                                      jnp.asarray(br)))
    jax_default = _np(jsub.upsample2x_conv(xb, kb, bb))
    jax_naive = _np(jsub.nearest_upsample2x_conv_reference(xb, kb, bb))
    wt = _torch_w(kr)
    port_default = _np(tsub.upsample2x_conv(torch.from_numpy(xr).bfloat16(), wt.bfloat16(),
                                            torch.from_numpy(br).bfloat16()))
    taps_bf16 = _np(tsub.upsample2x_conv(torch.from_numpy(xr), wt.bfloat16(),
                                         torch.from_numpy(br)))
    gap_jax, gap_port = _rel(jax_default, fp32), _rel(port_default, fp32)
    gap_naive = _rel(jax_naive, fp32)
    assert abs(gap_port - gap_jax) <= 0.05 * gap_jax, (gap_port, gap_jax)
    assert gap_jax > 1.1 * gap_naive, (gap_jax, gap_naive)
    for got in (jax_default, port_default):
        assert _rel(got, taps_bf16) <= 1.05 * gap_naive, (_rel(got, taps_bf16), gap_naive)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_knob_zero_is_jax_naive_path(monkeypatch, dtype):
    x, k, bias = _inputs(3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jsub.nearest_upsample2x_conv_reference(*(jnp.asarray(a, jdt) for a in (x, k, bias)))
    args = (torch.from_numpy(x).to(dtype), _torch_w(k).to(dtype), torch.from_numpy(bias).to(dtype))
    monkeypatch.setenv("ADAFACE_SUBPIXEL_UP", "0")
    got = tsub.upsample_conv(*args)
    assert torch.equal(got, tsub.nearest_upsample2x_conv_reference(*args))
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol * max(1.0, np.abs(_np(ref)).max()))
    monkeypatch.delenv("ADAFACE_SUBPIXEL_UP")
    assert torch.equal(tsub.upsample_conv(*args), tsub.upsample2x_conv(*args))


@pytest.mark.parametrize("which", ["unet", "vae"])
def test_upsample_modules_follow_the_knob(monkeypatch, which):
    """The UNet's and the VAE's `Upsample` in bf16 against JAX's module with
    the same weights. Knob unset: the port's fold, closer to JAX's module
    than half the gap to JAX's naive module. Under "0": the port's naive
    path, within the bf16 tolerance of JAX's naive module (flax rounds the
    conv before adding the bias, torch's conv adds it before rounding)."""
    c = 32
    x, k, bias = _inputs(4, c=c, co=c)
    jmod = (junet if which == "unet" else jvae).Upsample(dtype=jnp.bfloat16)
    params = {"params": {"conv": {"kernel": jnp.asarray(k), "bias": jnp.asarray(bias)}}}
    tmod = (tunet if which == "unet" else tvae).Upsample(c)
    with torch.no_grad():
        tmod.conv.weight.copy_(_torch_w(k))
        tmod.conv.bias.copy_(torch.from_numpy(bias))
    tmod = tmod.to(torch.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(x, jnp.bfloat16)
    w, b = tmod.conv.weight.detach(), tmod.conv.bias.detach()
    out = {}
    for knob, port_fn in ((None, tsub.upsample2x_conv),
                          ("0", tsub.nearest_upsample2x_conv_reference)):
        if knob is None:
            monkeypatch.delenv("ADAFACE_SUBPIXEL_UP", raising=False)
        else:
            monkeypatch.setenv("ADAFACE_SUBPIXEL_UP", knob)
        with torch.no_grad():
            got = tmod(xt)
        assert got.shape == (2, 12, 10, c)
        assert torch.equal(got, port_fn(xt, w, b)), knob
        out[knob] = (_np(jmod.apply(params, xj)), _np(got))
    monkeypatch.delenv("ADAFACE_SUBPIXEL_UP", raising=False)
    (jax_default, port_default), (jax_naive, port_naive) = out[None], out["0"]
    assert _rel(port_default, jax_default) < BF16_GAP_SHARE * _rel(jax_naive, jax_default)
    np.testing.assert_allclose(port_naive, jax_naive,
                               atol=2.0 ** -6 * np.abs(jax_naive).max())


def test_folded_kernels_follow_the_weight():
    """A frozen weight keeps its folded kernels between calls: they are
    folded again when the weight changes in place, one folded under
    inference mode serves a later call whose input takes a gradient, and a
    weight that takes a gradient, or was made in inference mode (no version
    counter), is folded on every call."""
    x, k, bias = _inputs(6, c=16, co=8)
    w = _torch_w(k)
    xt, bt = torch.from_numpy(x), torch.from_numpy(bias)
    ref = lambda w_: jsub.upsample2x_conv(jnp.asarray(x), jnp.asarray(
        w_.detach().numpy().transpose(2, 3, 1, 0)), jnp.asarray(bias))
    with torch.inference_mode():
        first = tsub.upsample2x_conv(xt, w, bt)
    kept = w._phase_kernels[2]
    assert torch.equal(tsub.upsample2x_conv(xt, w, bt), first)
    assert w._phase_kernels[2] is kept
    with torch.no_grad():
        w.mul_(-2.0)
    xg = xt.clone().requires_grad_(True)
    got = tsub.upsample2x_conv(xg, w, bt)
    assert w._phase_kernels[2] is not kept
    np.testing.assert_allclose(_np(got), np.asarray(ref(w)), atol=FP32_ATOL * 2)
    got.sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    wg = w.clone().requires_grad_(True)
    tsub.upsample2x_conv(xt, wg, bt).sum().backward()
    assert not hasattr(wg, "_phase_kernels") and wg.grad.abs().sum() > 0
    with torch.inference_mode():
        wi = w.clone()
        got = tsub.upsample2x_conv(xt, wi, bt)
    assert not hasattr(wi, "_phase_kernels")
    np.testing.assert_allclose(_np(got), np.asarray(ref(w)), atol=FP32_ATOL * 2)
