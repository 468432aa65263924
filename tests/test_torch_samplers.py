"""The port's schedules and samplers against the JAX package's, on the CPU in
fp32, with a toy eps function written alike in both (the samplers' own
arithmetic is what is compared; the UNet has tests of its own):

- `make_beta_schedule` (linear, cosine, sqrt_linear, sqrt) and
  `make_diffusion_schedule` (every field, `alphas_cumprod_prev` included)
  equal JAX's bit for bit; `make_ddim_timesteps(method="quad")` too, and
  its truncation (`.astype(int)`) is not a rounding; `make_ddim_schedule`
  with eta and either method (sigmas included);
- `ddim_sample` with eta noise, the mask / x0 blend and `return_pred_x0`,
  fed JAX's own draws in JAX's order (atol 1e-5); the mask keeps the
  original where it is 1, and the other reading falls outside;
- `stochastic_encode` and `ddim_decode` (fixed guidance);
- PLMS at S of 1, 3 and 7 (quad steps): S + 1 eps calls, JAX's result, at the fixed
  guidance scale (an annealed one falls outside)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaface_tpu.ops import schedule as jsched
from adaface_tpu.samplers import ddim as jddim
from adaface_tpu.samplers.plms import plms_sample as jplms

from adaface_tpu_torch.ops import schedule as tsched
from adaface_tpu_torch.samplers import ddim as tddim
from adaface_tpu_torch.samplers.plms import plms_sample as tplms

torch.set_num_threads(2)

ATOL = 1e-5
SHAPE = (2, 4, 4, 3)
FIELDS = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
          "sqrt_recipm1_alphas_cumprod")


@pytest.mark.parametrize("schedule", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_and_diffusion_schedules_equal_jax(schedule):
    np.testing.assert_array_equal(tsched.make_beta_schedule(schedule, 1000),
                                  jsched.make_beta_schedule(schedule, 1000))
    j = jsched.make_diffusion_schedule(schedule=schedule, cosine_s=0.01)
    t = tsched.make_diffusion_schedule(schedule=schedule, cosine_s=0.01)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)), err_msg=f)
    with pytest.raises(ValueError, match="unknown beta schedule"):
        tsched.make_beta_schedule("squared", 10)


@pytest.mark.parametrize("steps", [7, 20, 50])
def test_quad_timesteps_truncate(steps):
    got = tsched.make_ddim_timesteps(steps, 1000, "quad")
    np.testing.assert_array_equal(got, jsched.make_ddim_timesteps(steps, 1000, "quad"))
    rounded = np.unique(np.minimum(np.round(np.linspace(0, np.sqrt(800), steps) ** 2) + 1, 999))
    assert not np.array_equal(got, rounded)  # the other choice
    with pytest.raises(ValueError, match="unknown ddim discretization"):
        tsched.make_ddim_timesteps(steps, 1000, "cubic")


@pytest.mark.parametrize("eta,method,guidance", [(0.0, "uniform", (10.0, 4.0)),
                                                 (0.5, "uniform", 7.5), (1.0, "quad", 1.5)])
def test_ddim_schedule_equals_jax(eta, method, guidance):
    j = jsched.make_ddim_schedule(jsched.make_diffusion_schedule(), 20, eta=eta,
                                  guidance_scale=guidance, method=method)
    t = tsched.make_ddim_schedule(tsched.make_diffusion_schedule(), 20, eta=eta,
                                  guidance_scale=guidance, method=method)
    assert t.num_steps == j.num_steps
    for f in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas",
              "guidance_scales"):
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)), err_msg=f)
    assert t.sigmas.any() == (eta > 0)


def _eps_fns():
    """The same toy eps(x, t, g) in both packages: a conditional and an
    unconditional branch, blended by g as CFG does."""
    def jfn(x, t, g):
        s = (t.astype(jnp.float32) / 1000.0)[:, None, None, None]
        e_c, e_u = 0.3 * x * (1 + s) + 0.05, 0.2 * jnp.tanh(x) - 0.1 * s
        return e_u + g * (e_c - e_u)

    def tfn(x, t, g):
        s = (t.float() / 1000.0)[:, None, None, None]
        e_c, e_u = 0.3 * x * (1 + s) + 0.05, 0.2 * torch.tanh(x) - 0.1 * s
        return e_u + g * (e_c - e_u)

    return jfn, tfn


def _jax_draws(key, n_steps, mask, stochastic):
    """ddim_sample's normal draws in its order: per step the blend's, then
    the eta noise's."""
    out = []
    for _ in range(n_steps):
        for on in (mask, stochastic):
            if on:
                key, sub = jax.random.split(key)
                out.append(np.asarray(jax.random.normal(sub, SHAPE, jnp.float32)))
    return out


def _scheds(steps, eta, guidance=(6.0, 2.0), method="uniform"):
    return (jsched.make_diffusion_schedule(), tsched.make_diffusion_schedule(),
            jsched.make_ddim_schedule(jsched.make_diffusion_schedule(), steps, eta=eta,
                                      guidance_scale=guidance, method=method),
            tsched.make_ddim_schedule(tsched.make_diffusion_schedule(), steps, eta=eta,
                                      guidance_scale=guidance, method=method))


@pytest.mark.parametrize("stochastic,masked", [(True, False), (False, True), (True, True)])
def test_ddim_sample_with_eta_and_mask_equals_jax(stochastic, masked):
    rng = np.random.default_rng(0)
    x_T = rng.standard_normal(SHAPE).astype(np.float32)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    mask = (rng.uniform(size=(2, 4, 4, 1)) > 0.5).astype(np.float32)
    jb, tb, js, ts = _scheds(6, 0.7 if stochastic else 0.0)
    jfn, tfn = _eps_fns()
    key = jax.random.PRNGKey(3)
    kw = dict(mask=jnp.asarray(mask), x0=jnp.asarray(x0), base_sched=jb) if masked else {}
    ref, ref_x0 = jddim.ddim_sample(jfn, js, jnp.asarray(x_T), stochastic=stochastic,
                                    noise_key=key, return_pred_x0=True, **kw)
    draws = _jax_draws(key, ts.num_steps, masked, stochastic)
    tkw = dict(mask=torch.from_numpy(mask), x0=torch.from_numpy(x0), base_sched=tb) \
        if masked else {}
    got, got_x0 = tddim.ddim_sample(tfn, ts, torch.from_numpy(x_T), stochastic=stochastic,
                                    draws=draws, return_pred_x0=True, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(ref_x0), atol=ATOL)
    if masked:  # the mask keeps the original where it is 1; the reverse reading differs
        inv = tddim.ddim_sample(tfn, ts, torch.from_numpy(x_T), stochastic=stochastic,
                                draws=draws, base_sched=tb, mask=torch.from_numpy(1 - mask),
                                x0=torch.from_numpy(x0))
        assert np.abs(inv.numpy() - np.asarray(ref)).max() > 100 * ATOL


def test_ddim_sample_draws_from_a_generator():
    _, _, _, ts = _scheds(4, 1.0)
    _, tfn = _eps_fns()
    x = torch.zeros(SHAPE)
    a = tddim.ddim_sample(tfn, ts, x, stochastic=True,
                          generator=torch.Generator().manual_seed(1))
    b = tddim.ddim_sample(tfn, ts, x, stochastic=True,
                          generator=torch.Generator().manual_seed(1))
    c = tddim.ddim_sample(tfn, ts, x, stochastic=True,
                          generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator or draws"):
        tddim.ddim_sample(tfn, ts, x, stochastic=True)


@pytest.mark.parametrize("start", [0, 3, 7])
def test_stochastic_encode_and_ddim_decode_equal_jax(start):
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    jb, tb, js, ts = _scheds(8, 0.0)
    jfn, tfn = _eps_fns()
    t = np.full((2,), int(ts.timesteps[start]), np.int32)
    j_enc = jddim.stochastic_encode(jb, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    t_enc = tddim.stochastic_encode(tb, torch.from_numpy(x0), torch.from_numpy(t),
                                    torch.from_numpy(noise))
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), atol=ATOL)
    ref = jddim.ddim_decode(jfn, js, j_enc, start, guide_scale=6.0)
    got = tddim.ddim_decode(tfn, ts, t_enc, start, guide_scale=6.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("steps", [1, 3, 7])
def test_plms_equals_jax_with_one_more_call(steps):
    x_T = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    _, _, js, ts = _scheds(steps, 0.0, method="quad")  # exactly `steps` steps
    assert ts.num_steps == steps
    jfn, tfn = _eps_fns()
    calls = []

    def counted(x, t, g):
        calls.append(g)
        return tfn(x, t, g)

    ref = jplms(jfn, js, jnp.asarray(x_T), guide_scale=6.0)
    got = tplms(counted, ts, torch.from_numpy(x_T), guide_scale=6.0)
    assert len(calls) == steps + 1 and set(calls) == {6.0}
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    if steps > 1:  # the annealed scales are not PLMS's
        def annealed(x, t, g):
            i = int(np.nonzero(ts.timesteps == int(t[0]))[0][0])
            return tfn(x, t, float(ts.guidance_scales[i]))
        other = tplms(annealed, ts, torch.from_numpy(x_T), guide_scale=6.0)
        assert np.abs(other.numpy() - np.asarray(ref)).max() > 100 * ATOL
