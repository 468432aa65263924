"""DDIM sampling with classifier-free guidance (counterpart of
`adaface_tpu/samplers/ddim.py`, deterministic eta = 0 path). The JAX
`lax.scan` becomes a Python loop over the host-side per-step constants."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from adaface_tpu_torch.ops.schedule import DDIMSchedule

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


def ddim_step(x, eps, a, a_prev, s1m):
    """One deterministic (eta = 0) DDIM update, eps-parameterization ->
    x_prev. The step constants are float32 scalars (numpy), so the
    arithmetic matches the JAX scan's."""
    f32 = np.float32
    pred_x0 = (x - float(f32(s1m)) * eps) / float(np.sqrt(f32(a)))
    dir_coef = np.sqrt(np.maximum(f32(1.0) - f32(a_prev), f32(0.0)))
    return float(np.sqrt(f32(a_prev))) * pred_x0 + float(dir_coef) * eps


def ddim_sample(eps_fn: EpsFn, sched: DDIMSchedule, x_T: torch.Tensor) -> torch.Tensor:
    """The full deterministic DDIM loop from x_T [B, h, w, C] (fp32)."""
    b = x_T.shape[0]
    x = x_T
    for i in range(len(sched.timesteps)):
        t = torch.full((b,), int(sched.timesteps[i]), dtype=torch.int32, device=x.device)
        eps = eps_fn(x, t, float(sched.guidance_scales[i]))
        x = ddim_step(x, eps, sched.alphas[i], sched.alphas_prev[i],
                      sched.sqrt_one_minus_alphas[i])
    return x
