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

Under a dp mesh (`parallel/mesh.py`, the optimizer's `mesh` argument) the
state is ZeRO-1-sharded (`Zero1Layout`): a leaf of at least 65,536 elements holds only this rank's
slice along `zero1_sharding_rules`' dim, the accumulation, the clip and the
update run on that slice, and the updated parameter is reassembled on every
rank. Prodigy's global sums (`dots`, `d_denom`) and the clip's norm are
summed across ranks with each element counted once (a replicated leaf on dp
rank 0 only), so d, d_max and d_numerator stay equal on every rank.
`state_dict` gathers the full state on every rank, and `load_state_dict`
takes this rank's slice of a full state, so a checkpoint resumes at any dp.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from adaface_tpu_torch.parallel import mesh as pmesh

BETAS = (0.9, 0.999)
EPS = 1e-8
D0 = 1e-6  # initial d
GROWTH_RATE = float("inf")  # bound on d's growth per step


class Zero1Layout:
    """Which slice of each parameter this rank's optimizer state holds: the
    dim `zero1_sharding_rules` picks over `mesh`'s dp ranks (None:
    replicated; everything without a dp mesh)."""

    def __init__(self, params: List[torch.Tensor], mesh=None):
        self.mesh = mesh
        self.n = pmesh.dp_of(mesh)
        self.dims = (pmesh.zero1_sharding_rules(mesh, list(params)) if self.n > 1
                     else [None] * len(params))

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice (a view) of a tensor of parameter i's shape."""
        d = self.dims[i]
        if d is None:
            return t
        size = t.shape[d] // self.n
        return t.narrow(d, self.mesh.dp_rank * size, size)

    def gsum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The sum over every element of every rank of per-leaf local sums:
        a replicated leaf counts on dp rank 0 only."""
        if self.n == 1:
            return sum(parts)
        keep = [1.0 if d is not None or self.mesh.dp_rank == 0 else 0.0 for d in self.dims]
        return self.mesh.all_reduce_(sum(k * x for k, x in zip(keep, parts)))

    def full(self, i: int, t: torch.Tensor, shape) -> torch.Tensor:
        """Parameter i's whole tensor from every rank's slice `t` (an
        all-reduce of a zero-filled buffer)."""
        if self.dims[i] is None:
            return t
        out = torch.zeros(tuple(shape), dtype=t.dtype, device=t.device)
        self.local(i, out).copy_(t)
        return self.mesh.all_reduce_(out)

    def assemble_(self, i: int, p: torch.Tensor) -> None:
        """Every rank's updated slice of parameter i into its whole tensor."""
        if self.dims[i] is not None:
            p.copy_(self.full(i, self.local(i, p).clone(), p.shape))


class Prodigy:
    """Prodigy (D-adaptation Adam) on `params` with the JAX transformation's
    defaults: betas (0.9, 0.999), beta3 = sqrt(beta2), d0 1e-6, no bias
    correction, no weight decay. State is fp32 on the params' device; the
    global statistics are 0-dim tensors. ZeRO-1-sharded over a dp `mesh`."""

    def __init__(self, params: List[torch.Tensor], lr: float = 1.0, d_coef: float = 1.0,
                 mesh=None):
        self.params = list(params)
        self.lr, self.d_coef = lr, d_coef
        self.zero = Zero1Layout(self.params, mesh)
        dev = self.params[0].device
        scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        self.step_count = 0
        self.d, self.d_max, self.d_numerator = scalar(D0), scalar(D0), scalar(0.0)
        loc = [self.zero.local(i, p) for i, p in enumerate(self.params)]
        zeros = lambda: [torch.zeros_like(t, dtype=torch.float32) for t in loc]
        self.exp_avg, self.exp_avg_sq, self.s = zeros(), zeros(), zeros()
        self.p0 = [t.detach().clone().float() for t in loc]

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None):
        """One update from the gradients in `.grad`, or from `grads` (this
        rank's slices, as `AccumulatedClipped` passes them)."""
        (b1, b2), b3, d0 = BETAS, BETAS[1] ** 0.5, D0
        z = self.zero
        d = self.d
        dlr = d * self.lr
        if grads is None:
            grads = [z.local(i, p.grad) for i, p in enumerate(self.params)]
        grads = [g.float() for g in grads]
        ploc = [z.local(i, p) for i, p in enumerate(self.params)]
        dots = z.gsum([torch.sum(g * (p0 - p.float()))
                       for g, p0, p in zip(grads, self.p0, ploc)])
        self.d_numerator = self.d_numerator * b3 + (d / d0) * dlr * dots
        s_coef = (d / d0) * dlr
        for m, v, s, g in zip(self.exp_avg, self.exp_avg_sq, self.s, grads):
            m.copy_(b1 * m + d * (1 - b1) * g)
            v.copy_(b2 * v + d * d * (1 - b2) * torch.square(g))
            s.copy_(b3 * s + s_coef * g)
        d_denom = z.gsum([torch.sum(torch.abs(s)) for s in self.s])
        pos = d_denom > 0
        d_hat = torch.where(pos, self.d_coef * self.d_numerator
                            / torch.clamp_min(d_denom, 1e-30), d)
        d_boot = torch.where(d == d0, torch.maximum(d, d_hat), d)
        d_max = torch.maximum(self.d_max, d_hat)
        d_new = torch.where(pos, torch.minimum(d_max, d_boot * GROWTH_RATE), d)
        self.d_max = torch.where(pos, d_max, self.d_max)
        for i, (p, m, v) in enumerate(zip(ploc, self.exp_avg, self.exp_avg_sq)):
            p.add_((-dlr * m / (torch.sqrt(v) + d_new * EPS)).to(p.dtype))
            z.assemble_(i, self.params[i])
        self.d = d_new
        self.step_count += 1

    _TENSORS = ("d", "d_max", "d_numerator")
    _LISTS = ("exp_avg", "exp_avg_sq", "s", "p0")

    def state_dict(self) -> dict:
        """The whole state as plain CPU tensors and ints (for `torch.save`),
        gathered on every rank under ZeRO-1."""
        out = {"step_count": self.step_count}
        out.update({n: getattr(self, n).detach().cpu().clone() for n in self._TENSORS})
        out.update({n: _gather_list(self.zero, self.params, getattr(self, n))
                    for n in self._LISTS})
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self.step_count = int(state["step_count"])
        for n in self._TENSORS:
            getattr(self, n).copy_(state[n])
        for n in self._LISTS:
            _load_list(self.zero, getattr(self, n), state[n])


def _gather_list(zero: Zero1Layout, params, local: List[torch.Tensor]) -> List[torch.Tensor]:
    """Whole CPU copies of per-parameter state slices."""
    return [zero.full(i, t.detach(), p.shape).cpu().clone()
            for i, (p, t) in enumerate(zip(params, local))]


def _load_list(zero: Zero1Layout, local: List[torch.Tensor], full: List[torch.Tensor]):
    """This rank's slices of whole saved state tensors, copied in place."""
    for i, (dst, src) in enumerate(zip(local, full)):
        dst.copy_(zero.local(i, torch.as_tensor(src)))


class AccumulatedClipped:
    """optax.MultiSteps(chain(clip_by_global_norm(max_norm), inner), every_k)
    over `inner.params`: call `step()` after each micro-step's backward."""

    def __init__(self, inner, max_norm: float, every_k: int = 1):
        self.inner, self.max_norm, self.every_k = inner, max_norm, every_k
        self.params = inner.params
        self.zero = inner.zero
        self.mini_step = 0
        self.acc = [torch.zeros_like(self.zero.local(i, p), dtype=torch.float32)
                    for i, p in enumerate(self.params)]

    @torch.no_grad()
    def step(self) -> bool:
        """Fold this micro-step's gradients into the running mean; on the
        k-th, clip the mean and update. Clears `.grad`. Returns True when
        the parameters changed."""
        n = self.mini_step
        z = self.zero
        for i, (a, p) in enumerate(zip(self.acc, self.params)):
            g = torch.zeros_like(a) if p.grad is None else z.local(i, p.grad).float()
            a.copy_(a + (g - a) / (n + 1))
            p.grad = None
        if n < self.every_k - 1:
            self.mini_step = n + 1
            return False
        norm = torch.sqrt(z.gsum([torch.sum(a * a) for a in self.acc]))
        clip = norm >= self.max_norm
        self.inner.step([torch.where(clip, a / norm * self.max_norm, a).to(p.dtype)
                         for a, p in zip(self.acc, self.params)])
        for a in self.acc:
            a.zero_()
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        """The accumulation state (micro-step count and running mean) and the
        inner optimizer's, as plain CPU tensors and ints (whole on every
        rank under ZeRO-1)."""
        return {"mini_step": self.mini_step,
                "acc": _gather_list(self.zero, self.params, self.acc),
                "inner": self.inner.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self.mini_step = int(state["mini_step"])
        _load_list(self.zero, self.acc, state["acc"])
        self.inner.load_state_dict(state["inner"])
