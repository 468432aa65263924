"""flax's default initial laws for the port's seeded smoke weights."""

from __future__ import annotations

import torch
import torch.nn as nn

# the standard deviation of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def seeded(model: nn.Module, seed: int, device=None) -> nn.Module:
    """`model` (built on the CPU) with flax's defaults drawn from a CPU
    torch seed, moved to `device`, in eval mode, so that every device gets
    the same numbers: every conv weight LeCun-normal
    (`truncated_normal(-2, 2) * sqrt(1 / fan_in) / 0.8796...`), conv biases
    0; BatchNorm and GroupNorm parameters keep torch's identity defaults."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                w = m.weight
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
                w.mul_((1.0 / w[0].numel()) ** 0.5 / _TRUNC_STD)
                if m.bias is not None:
                    m.bias.zero_()
    return model.to(device).eval()
