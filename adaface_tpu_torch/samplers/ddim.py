"""DDIM sampling with classifier-free guidance (counterpart of
`adaface_tpu/samplers/ddim.py`). The JAX `lax.scan` becomes a Python loop
over the host-side per-step constants.

Random draws (the eta noise, the mask blend's re-noising of x0) come from
`draws`, an iterator of tensors consumed in the JAX package's order (per
step: the blend's draw, then the eta draw), when given, else from
`generator` on x's device; the numbers of a torch.Generator differ from
`jax.random`'s, their law does not.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from adaface_tpu_torch.ops.schedule import DDIMSchedule, DiffusionSchedule

# eps_fn(x, t_batch, guide_scale) -> eps
EpsFn = Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]


def make_cfg_eps_fn(apply_fn: Callable, context_cond: torch.Tensor,
                    context_uncond: torch.Tensor, dedup: bool = False,
                    kv_fn: Optional[Callable] = None) -> EpsFn:
    """CFG around `apply_fn(x, t, ctx[, kv])`: one UNet call on the
    (cond; uncond) batch, e = e_u + g * (e_c - e_u). With `dedup`, x and t
    pass at batch B and the UNet tiles after its stem. `kv_fn(ctx)`
    computes the loop-invariant cross-attention K/V once, here."""
    cc = context_cond if context_cond.dim() == 4 else context_cond[None]
    cu = context_uncond if context_uncond.dim() == 4 else context_uncond[None]
    ctx = torch.cat([cc, cu.expand_as(cc)], dim=1)
    extra = (kv_fn(ctx),) if kv_fn is not None else ()

    def eps_fn(x, t, guide_scale):
        if dedup:
            eps2 = apply_fn(x, t, ctx, *extra)
        else:
            eps2 = apply_fn(torch.cat([x, x]), torch.cat([t, t]), ctx, *extra)
        e_c, e_u = eps2.chunk(2, dim=0)
        return e_u + guide_scale * (e_c - e_u)

    return eps_fn


def ddim_step(x, eps, a, a_prev, s1m, sigma=0.0, noise: Optional[torch.Tensor] = None):
    """One DDIM update, eps-parameterization -> (x_prev, pred_x0). The step
    constants are float32 scalars (numpy), so the arithmetic matches the JAX
    scan's; `noise` (times sigma) is added when given."""
    f32 = np.float32
    pred_x0 = (x - float(f32(s1m)) * eps) / float(np.sqrt(f32(a)))
    dir_coef = np.sqrt(np.maximum(f32(1.0) - f32(a_prev) - f32(sigma) ** 2, f32(0.0)))
    x_prev = float(np.sqrt(f32(a_prev))) * pred_x0 + float(dir_coef) * eps
    if noise is not None:
        x_prev = x_prev + float(f32(sigma)) * noise
    return x_prev, pred_x0


def _drawer(draws: Optional[Iterator[torch.Tensor]], generator: Optional[torch.Generator]):
    """A function like -> a standard normal draw of like's shape: the next
    of `draws`, else one from `generator`."""
    def draw(like: torch.Tensor) -> torch.Tensor:
        if draws is not None:
            d = next(draws)
            d = d if torch.is_tensor(d) else torch.from_numpy(np.array(d, np.float32))
            return d.to(like.device, torch.float32)
        return torch.randn(like.shape, generator=generator, device=like.device)
    return draw


def ddim_sample(eps_fn: EpsFn, sched: DDIMSchedule, x_T: torch.Tensor, *,
                stochastic: bool = False, generator: Optional[torch.Generator] = None,
                draws: Optional[Iterator[torch.Tensor]] = None,
                mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
                base_sched: Optional[DiffusionSchedule] = None,
                return_pred_x0: bool = False):
    """The DDIM loop from x_T [B, h, w, C] (fp32). `stochastic` adds the
    eta noise sigma_i * N(0, 1) at each step. With `mask` (1 = keep the
    original) and `x0`, each step first blends x with x0 re-noised to the
    step's t through `base_sched.q_sample`. Returns the last latent, and the
    last pred_x0 with `return_pred_x0`."""
    if stochastic and draws is None and generator is None:
        raise ValueError("stochastic sampling needs a generator or draws")
    draw = _drawer(None if draws is None else iter(draws), generator)
    b = x_T.shape[0]
    x, pred_x0 = x_T, None
    for i in range(len(sched.timesteps)):
        t = torch.full((b,), int(sched.timesteps[i]), dtype=torch.int32, device=x.device)
        if mask is not None:
            img_orig = base_sched.q_sample(x0, t, draw(x))
            x = img_orig * mask + (1.0 - mask) * x
        eps = eps_fn(x, t, float(sched.guidance_scales[i]))
        x, pred_x0 = ddim_step(x, eps, sched.alphas[i], sched.alphas_prev[i],
                               sched.sqrt_one_minus_alphas[i], sched.sigmas[i],
                               draw(x) if stochastic else None)
    return (x, pred_x0) if return_pred_x0 else x


def stochastic_encode(base_sched: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
    """x0 noised to timestep t (q_sample)."""
    return base_sched.q_sample(x0, t, noise)


def ddim_decode(eps_fn: EpsFn, sched: DDIMSchedule, x_t: torch.Tensor, t_start_index: int,
                guide_scale: float) -> torch.Tensor:
    """img2img's decode: the deterministic tail of the schedule from
    sampling index `t_start_index` (0 = the whole run) at one fixed
    guidance scale (no annealing)."""
    b = x_t.shape[0]
    x = x_t
    g = float(np.float32(guide_scale))
    for i in range(t_start_index, len(sched.timesteps)):
        t = torch.full((b,), int(sched.timesteps[i]), dtype=torch.int32, device=x.device)
        eps = eps_fn(x, t, g)
        x, _ = ddim_step(x, eps, sched.alphas[i], sched.alphas_prev[i],
                         sched.sqrt_one_minus_alphas[i], sched.sigmas[i])
    return x
