"""PLMS (pseudo linear multistep) sampling (counterpart of
`adaface_tpu/samplers/plms.py`): Adams-Bashforth on the eps predictions.
The first step is second order through an extra UNet call at the next
timestep (so S steps make S + 1 calls), the second and third use the lower
orders, the rest the fourth. PLMS runs at one fixed guidance scale: the
schedule's annealed scales are not read.
"""

from __future__ import annotations

import numpy as np
import torch

from adaface_tpu_torch.ops.schedule import DDIMSchedule
from adaface_tpu_torch.samplers.ddim import EpsFn, ddim_step


def plms_sample(eps_fn: EpsFn, sched: DDIMSchedule, x_T: torch.Tensor,
                guide_scale: float = 7.5) -> torch.Tensor:
    b = x_T.shape[0]
    S = sched.num_steps
    g = float(np.float32(guide_scale))

    def model(x, i):
        t = torch.full((b,), int(sched.timesteps[i]), dtype=torch.int32, device=x.device)
        return eps_fn(x, t, g)

    def update(x, e_prime, i):
        return ddim_step(x, e_prime, sched.alphas[i], sched.alphas_prev[i],
                         sched.sqrt_one_minus_alphas[i], sched.sigmas[i])[0]

    x = x_T
    old_eps = []
    for i in range(S):
        e_t = model(x, i)
        if i == 0:
            e_next = model(update(x, e_t, 0), min(1, S - 1))
            e_prime = (e_t + e_next) / 2
        elif i == 1:
            e_prime = (3 * e_t - old_eps[-1]) / 2
        elif i == 2:
            e_prime = (23 * e_t - 16 * old_eps[-1] + 5 * old_eps[-2]) / 12
        else:
            e_prime = (55 * e_t - 59 * old_eps[-1] + 37 * old_eps[-2] - 9 * old_eps[-3]) / 24
        x = update(x, e_prime, i)
        old_eps = (old_eps + [e_t])[-3:]
    return x
