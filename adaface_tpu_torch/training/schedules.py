"""LR schedules as plain step -> multiplier functions (the port's copy of
`adaface_tpu/training/schedules.py`). Each takes a step as a Python number,
a numpy array or a torch tensor and returns a float32 value of the same
kind.

- `lambda_warmup_cosine`: linear warmup lr_start -> lr_max, then cosine to
  lr_min (LambdaWarmUpCosineScheduler, the AdamW path).
- `prodigy_cycle_schedule`: the Prodigy path: constant 1.0 through the
  warmup, then N cycles of Linear (1 -> 1/11 over 1.1x the cycle),
  CosineAnnealingWarmRestarts (eta_min 0.1) or CyclicLR (a 0.1 <-> 1
  triangle starting at the top).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def _as_f32(step):
    """(float32 array or tensor of `step`, the function that hands the
    result back in the caller's kind)."""
    if torch.is_tensor(step):
        return step.to(torch.float32), lambda v: v
    a = np.asarray(step, np.float32)
    return torch.from_numpy(np.array(a)), (lambda v: v.numpy() if a.ndim else np.float32(v.item()))


def lambda_warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float,
                         lr_start: float, max_decay_steps: int) -> Callable:
    def sched(step):
        s, back = _as_f32(step)
        warm = lr_start + (lr_max - lr_start) / max(warm_up_steps, 1) * s
        t = torch.clamp((s - warm_up_steps) / max(max_decay_steps - warm_up_steps, 1), 0, 1)
        cos = lr_min + 0.5 * (lr_max - lr_min) * (1 + torch.cos(t * math.pi))
        return back(torch.where(s < warm_up_steps, warm, cos))

    return sched


def prodigy_cycle_schedule(warm_up_steps: int, max_steps: int,
                           scheduler_type: str = "Linear", num_cycles: int = 1) -> Callable:
    if scheduler_type not in ("Linear", "CosineAnnealingWarmRestarts", "CyclicLR"):
        raise NotImplementedError(scheduler_type)
    eff_cycles = num_cycles - 0.5 if scheduler_type == "CyclicLR" else float(num_cycles)
    single = (max_steps - warm_up_steps) / eff_cycles

    def sched(step):
        s, back = _as_f32(step)
        t = torch.clamp_min(s - warm_up_steps, 0.0)
        if scheduler_type == "Linear":
            # linear 1 -> 1/11 within each cycle; cycles restart at the
            # milestones
            pos = torch.remainder(t, single)
            mult = torch.clamp(1.0 - pos / (single * 1.1), 1.0 / 11.0, 1.0)
        elif scheduler_type == "CosineAnnealingWarmRestarts":
            pos = torch.remainder(t, single) / single
            mult = 0.1 + 0.5 * (1.0 - 0.1) * (1 + torch.cos(pos * math.pi))
        else:
            # a 0.1 <-> 1.0 triangle wave starting at the top (half a cycle in)
            pos = torch.remainder(t + single / 2.0, single) / single
            tri = torch.where(pos < 0.5, pos * 2, 2 - pos * 2)
            mult = 0.1 + (1.0 - 0.1) * tri
        return back(torch.where(s < warm_up_steps, torch.ones_like(mult), mult))

    return sched
