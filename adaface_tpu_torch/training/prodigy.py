"""The trainer's optimizer chain (counterpart of
`adaface_tpu/training/prodigy.py` and of the optax chain the JAX trainer
builds, `MultiSteps(chain(clip_by_global_norm(clip), prodigy), every_k)`):

- `Prodigy`: D-adaptation Adam with the same state and update as the JAX
  transformation, including the `d == d0` bootstrap and the guard that keeps
  d when the denominator is 0;
- `AccumulatedClipped`: gradient accumulation over `every_k` micro-steps as
  optax.MultiSteps does it (the running mean of the micro-step gradients),
  global-norm clipping of that mean with optax's formula (g / norm * max
  when norm >= max, no epsilon, unlike `torch.nn.utils.clip_grad_norm_`),
  then the inner optimizer on the k-th micro-step only; the other
  micro-steps change nothing.

Both work on a list of tensors updated in place (the trainer's embedder
leaves); the inner optimizer (Prodigy, or `adamw.AdamW`) reads `.grad`.
`state_dict` / `load_state_dict` give and restore the whole state as plain
tensors, for the trainer's resumable state.
"""

from __future__ import annotations

from typing import List

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8
D0 = 1e-6  # initial d
GROWTH_RATE = float("inf")  # bound on d's growth per step


class Prodigy:
    """Prodigy (D-adaptation Adam) on `params` with the JAX transformation's
    defaults: betas (0.9, 0.999), beta3 = sqrt(beta2), d0 1e-6, no bias
    correction, no weight decay. State is fp32 on the params' device; the
    global statistics are 0-dim tensors."""

    def __init__(self, params: List[torch.Tensor], lr: float = 1.0, d_coef: float = 1.0):
        self.params = list(params)
        self.lr, self.d_coef = lr, d_coef
        dev = self.params[0].device
        scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        self.step_count = 0
        self.d, self.d_max, self.d_numerator = scalar(D0), scalar(D0), scalar(0.0)
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.exp_avg, self.exp_avg_sq, self.s = zeros(), zeros(), zeros()
        self.p0 = [p.detach().clone().float() for p in self.params]

    @torch.no_grad()
    def step(self):
        """One update from the gradients in `.grad`."""
        (b1, b2), b3, d0 = BETAS, BETAS[1] ** 0.5, D0
        d = self.d
        dlr = d * self.lr
        grads = [p.grad.float() for p in self.params]
        dots = sum(torch.sum(g * (p0 - p.float()))
                   for g, p0, p in zip(grads, self.p0, self.params))
        self.d_numerator = self.d_numerator * b3 + (d / d0) * dlr * dots
        s_coef = (d / d0) * dlr
        for m, v, s, g in zip(self.exp_avg, self.exp_avg_sq, self.s, grads):
            m.copy_(b1 * m + d * (1 - b1) * g)
            v.copy_(b2 * v + d * d * (1 - b2) * torch.square(g))
            s.copy_(b3 * s + s_coef * g)
        d_denom = sum(torch.sum(torch.abs(s)) for s in self.s)
        pos = d_denom > 0
        d_hat = torch.where(pos, self.d_coef * self.d_numerator
                            / torch.clamp_min(d_denom, 1e-30), d)
        d_boot = torch.where(d == d0, torch.maximum(d, d_hat), d)
        d_max = torch.maximum(self.d_max, d_hat)
        d_new = torch.where(pos, torch.minimum(d_max, d_boot * GROWTH_RATE), d)
        self.d_max = torch.where(pos, d_max, self.d_max)
        for p, m, v in zip(self.params, self.exp_avg, self.exp_avg_sq):
            p.add_((-dlr * m / (torch.sqrt(v) + d_new * EPS)).to(p.dtype))
        self.d = d_new
        self.step_count += 1

    _TENSORS = ("d", "d_max", "d_numerator")
    _LISTS = ("exp_avg", "exp_avg_sq", "s", "p0")

    def state_dict(self) -> dict:
        """The whole state as plain CPU tensors and ints (for `torch.save`)."""
        out = {"step_count": self.step_count}
        out.update({n: getattr(self, n).detach().cpu().clone() for n in self._TENSORS})
        out.update({n: [t.detach().cpu().clone() for t in getattr(self, n)] for n in self._LISTS})
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self.step_count = int(state["step_count"])
        for n in self._TENSORS:
            getattr(self, n).copy_(state[n])
        for n in self._LISTS:
            for dst, src in zip(getattr(self, n), state[n]):
                dst.copy_(src)


class AccumulatedClipped:
    """optax.MultiSteps(chain(clip_by_global_norm(max_norm), inner), every_k)
    over `inner.params`: call `step()` after each micro-step's backward."""

    def __init__(self, inner, max_norm: float, every_k: int = 1):
        self.inner, self.max_norm, self.every_k = inner, max_norm, every_k
        self.params = inner.params
        self.mini_step = 0
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self) -> bool:
        """Fold this micro-step's gradients into the running mean; on the
        k-th, clip the mean and update. Clears `.grad`. Returns True when
        the parameters changed."""
        n = self.mini_step
        for a, p in zip(self.acc, self.params):
            g = torch.zeros_like(a) if p.grad is None else p.grad.float()
            a.copy_(a + (g - a) / (n + 1))
            p.grad = None
        if n < self.every_k - 1:
            self.mini_step = n + 1
            return False
        norm = torch.sqrt(sum(torch.sum(a * a) for a in self.acc))
        clip = norm >= self.max_norm
        for a, p in zip(self.acc, self.params):
            p.grad = torch.where(clip, a / norm * self.max_norm, a).to(p.dtype)
        self.inner.step()
        for a, p in zip(self.acc, self.params):
            a.zero_()
            p.grad = None
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        """The accumulation state (micro-step count and running mean) and the
        inner optimizer's, as plain CPU tensors and ints."""
        return {"mini_step": self.mini_step,
                "acc": [a.detach().cpu().clone() for a in self.acc],
                "inner": self.inner.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self.mini_step = int(state["mini_step"])
        for dst, src in zip(self.acc, state["acc"]):
            dst.copy_(src)
        self.inner.load_state_dict(state["inner"])
