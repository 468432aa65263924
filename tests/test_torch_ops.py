"""Port parity: schedules and elementwise/normalization ops of
`adaface_tpu_torch.ops` against `adaface_tpu.ops`, fp32 on the CPU, same
numpy inputs. Tolerance atol 1e-5 unless a test says otherwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaface_tpu.ops import basic as jbasic
from adaface_tpu.ops import schedule as jsched
from adaface_tpu.ops.subpixel import nearest_upsample2x_conv_reference
from adaface_tpu_torch.ops import basic as tbasic
from adaface_tpu_torch.ops import schedule as tsched
from adaface_tpu_torch.ops import subpixel as tsub

torch.set_num_threads(2)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("steps,guidance", [(50, (10.0, 4.0)), (7, 7.5), (3, 1.5)])
def test_ddim_schedule_matches(steps, guidance):
    jb = jsched.make_diffusion_schedule()
    tb = tsched.make_diffusion_schedule()
    for f in ("betas", "alphas_cumprod"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)), getattr(tb, f))
    js = jsched.make_ddim_schedule(jb, steps, guidance_scale=guidance)
    ts = tsched.make_ddim_schedule(tb, steps, guidance_scale=guidance)
    assert ts.num_steps == js.num_steps
    assert not np.asarray(js.sigmas).any()  # eta = 0, the only DDIM the port runs
    for f in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas",
              "guidance_scales"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f), err_msg=f)


@pytest.mark.parametrize("t_max,atol", [(64, ATOL), (1000, 2e-4)])
def test_timestep_embedding(rng, t_max, atol):
    # torch's and XLA's fp32 exp differ by 1 ulp on a few frequencies; a
    # timestep t scales that to t * 6e-8 rad, so t up to 999 needs 2e-4
    t = rng.integers(0, t_max, size=6).astype(np.int32)
    for dim in (32, 33, 320):
        ref = jbasic.timestep_embedding(jnp.asarray(t), dim)
        got = tbasic.timestep_embedding(torch.from_numpy(t), dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_both_eps(rng, eps):
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32) * 3 + 0.5
    scale = 1 + 0.1 * rng.standard_normal(64).astype(np.float32)
    bias = 0.1 * rng.standard_normal(64).astype(np.float32)
    ref = jbasic.group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, eps)
    got = tbasic.group_norm(_t(x), _t(scale), _t(bias), 32, eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_group_norm_constant_group_clamps_variance():
    # one-pass E[x^2] - mean^2 can go below 0 in fp32; both clamp at 0
    x = np.full((1, 4, 4, 32), 3.0, np.float32)
    s, b = np.ones(32, np.float32), np.zeros(32, np.float32)
    ref = jbasic.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 32, 1e-6)
    got = tbasic.group_norm(_t(x), _t(s), _t(b), 32, 1e-6)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_layer_norm(rng):
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    s = 1 + 0.1 * rng.standard_normal(48).astype(np.float32)
    b = 0.1 * rng.standard_normal(48).astype(np.float32)
    ref = jbasic.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5)
    got = tbasic.layer_norm(_t(x), _t(s), _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_geglu_uses_tanh_gelu(rng):
    x = rng.uniform(-4, 4, size=(4, 64)).astype(np.float32)
    ref = jbasic.geglu(jnp.asarray(x))
    got = tbasic.geglu(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_quick_gelu(rng):
    x = rng.uniform(-6, 6, size=(4, 64)).astype(np.float32)
    np.testing.assert_allclose(tbasic.quick_gelu(_t(x)).numpy(),
                               np.asarray(jbasic.quick_gelu(jnp.asarray(x))), atol=ATOL)


def test_upsample2x_conv_matches_reference(rng):
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    k = (0.2 * rng.standard_normal((3, 3, 8, 12))).astype(np.float32)  # HWIO
    b = rng.standard_normal(12).astype(np.float32)
    ref = nearest_upsample2x_conv_reference(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    # the port's ADAFACE_SUBPIXEL_UP=0 path (tests/test_torch_subpixel.py holds the fold)
    got = tsub.nearest_upsample2x_conv_reference(_t(x), _t(k.transpose(3, 2, 0, 1)), _t(b))
    assert got.shape == (2, 10, 12, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
