"""AdamW with optax's function and defaults (counterpart of the
`optax.adamw(learning_rate)` that the JAX trainer builds when `use_prodigy`
is off): b1 0.9, b2 0.999, eps 1e-8 outside the square root, eps_root 0,
weight decay 1e-4 (torch.optim.AdamW's default is 1e-2), bias-corrected
moments (the corrections taken in fp32, as optax takes them), and the decay
added to the update before the learning rate scales it:

    m = (1 - b1) g + b1 m,  v = (1 - b2) g^2 + b2 v,  t += 1
    p -= lr * (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd * p)

It works on a list of tensors updated in place and reads `.grad`, like
`prodigy.Prodigy`, so `prodigy.AccumulatedClipped` wraps it the same way;
over a dp `mesh` its moments are ZeRO-1-sharded as Prodigy's are.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from adaface_tpu_torch.training.prodigy import Zero1Layout, _gather_list, _load_list

B1, B2, EPS, EPS_ROOT, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.0, 1e-4


class AdamW:
    def __init__(self, params: List[torch.Tensor], lr: float, weight_decay: float = WEIGHT_DECAY,
                 mesh=None):
        self.params = list(params)
        self.lr, self.weight_decay = lr, weight_decay
        self.zero = Zero1Layout(self.params, mesh)
        self.step_count = 0
        zeros = lambda: [torch.zeros_like(self.zero.local(i, p), dtype=torch.float32)
                         for i, p in enumerate(self.params)]
        self.exp_avg, self.exp_avg_sq = zeros(), zeros()

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None):
        """One update from the gradients in `.grad`, or from `grads` (this
        rank's slices)."""
        z = self.zero
        if grads is None:
            grads = [z.local(i, p.grad) for i, p in enumerate(self.params)]
        self.step_count += 1
        # optax's bias corrections, 1 - decay^t taken in fp32 (1 - 0.999^t
        # loses ~1e-5 of its value to the cancellation; so does optax)
        t = np.float32(self.step_count)
        bc1 = float(np.float32(1.0) - np.float32(B1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(B2) ** t)
        for i, (full, m, v, g) in enumerate(zip(self.params, self.exp_avg, self.exp_avg_sq,
                                                grads)):
            p = z.local(i, full)
            g = g.float()
            m.copy_((1 - B1) * g + B1 * m)
            v.copy_((1 - B2) * torch.square(g) + B2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2 + EPS_ROOT) + EPS) + self.weight_decay * p.float()
            p.add_((-self.lr * u).to(p.dtype))
            z.assemble_(i, full)

    def state_dict(self) -> dict:
        return {"step_count": self.step_count,
                "exp_avg": _gather_list(self.zero, self.params, self.exp_avg),
                "exp_avg_sq": _gather_list(self.zero, self.params, self.exp_avg_sq)}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self.step_count = int(state["step_count"])
        for name in ("exp_avg", "exp_avg_sq"):
            _load_list(self.zero, getattr(self, name), state[name])
