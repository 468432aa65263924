"""AdamW with optax's function and defaults (counterpart of the
`optax.adamw(learning_rate)` that the JAX trainer builds when `use_prodigy`
is off): b1 0.9, b2 0.999, eps 1e-8 outside the square root, eps_root 0,
weight decay 1e-4 (torch.optim.AdamW's default is 1e-2), bias-corrected
moments (the corrections taken in fp32, as optax takes them), and the decay
added to the update before the learning rate scales it:

    m = (1 - b1) g + b1 m,  v = (1 - b2) g^2 + b2 v,  t += 1
    p -= lr * (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd * p)

It works on a list of tensors updated in place and reads `.grad`, like
`prodigy.Prodigy`, so `prodigy.AccumulatedClipped` wraps it the same way.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

B1, B2, EPS, EPS_ROOT, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.0, 1e-4


class AdamW:
    def __init__(self, params: List[torch.Tensor], lr: float, weight_decay: float = WEIGHT_DECAY):
        self.params = list(params)
        self.lr, self.weight_decay = lr, weight_decay
        self.step_count = 0
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.exp_avg, self.exp_avg_sq = zeros(), zeros()

    @torch.no_grad()
    def step(self):
        """One update from the gradients in `.grad`."""
        self.step_count += 1
        # optax's bias corrections, 1 - decay^t taken in fp32 (1 - 0.999^t
        # loses ~1e-5 of its value to the cancellation; so does optax)
        t = np.float32(self.step_count)
        bc1 = float(np.float32(1.0) - np.float32(B1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(B2) ** t)
        for p, m, v in zip(self.params, self.exp_avg, self.exp_avg_sq):
            g = p.grad.float()
            m.copy_((1 - B1) * g + B1 * m)
            v.copy_((1 - B2) * torch.square(g) + B2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2 + EPS_ROOT) + EPS) + self.weight_decay * p.float()
            p.add_((-self.lr * u).to(p.dtype))

    def state_dict(self) -> dict:
        return {"step_count": self.step_count,
                "exp_avg": [t.detach().cpu().clone() for t in self.exp_avg],
                "exp_avg_sq": [t.detach().cpu().clone() for t in self.exp_avg_sq]}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self.step_count = int(state["step_count"])
        for name in ("exp_avg", "exp_avg_sq"):
            for dst, src in zip(getattr(self, name), state[name]):
                dst.copy_(src)
