"""Gradient-flow utilities (counterpart of `adaface_tpu/ops/grad.py`).

- `scale_grad`: identity forward, gradient times `alpha` backward (the
  reference's `gen_gradient_scaler`); alpha 1 is a no-op, 0 a detach.
- `add_noise_to_tensor`: Gaussian noise with a std relative to the tensor's
  own (population, ddof 0) std, which is detached.
- `recompute_grads`: the backward of a kernel that has no backward kernel,
  by running its plain version again under autograd (a `jax.vjp` of the
  plain function in the JAX package's `custom_vjp`s).
- `perturb_params`: each embedder leaf scaled by U(1 - r, 1 + r) noise (the
  reference's `perturb_model_parameters`, applied after a resume).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def scale_grad(x: torch.Tensor, alpha: float) -> torch.Tensor:
    if alpha == 1:
        return x
    if alpha == 0:
        return x.detach()
    return x * alpha + (x * (1.0 - alpha)).detach()


def add_noise_to_tensor(ts: torch.Tensor, noise_std: float,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ts + noise * noise_std * mean(std(ts, -1)), the std relative to the
    tensor's own: the population std (ddof 0; torch.std defaults to the
    unbiased one), detached. The unit noise is `noise` when given (tests pass
    the same numbers to both packages), else drawn from `generator` on ts's
    device. (The JAX function's absolute-std and keep-norm variants have no
    caller here.)"""
    std = noise_std * ts.detach().std(dim=-1, unbiased=False).mean()
    if noise is None:
        noise = torch.randn(ts.shape, generator=generator, device=ts.device, dtype=ts.dtype)
    return ts + noise.to(ts.dtype) * std


def recompute_grads(fn: Callable, saved: Sequence[torch.Tensor], needs: Sequence[bool],
                    grad_out: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of fn(*saved) against grad_out for the inputs whose `needs`
    flag is set, None for the others, by running fn again under autograd."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        grads = iter(torch.autograd.grad(fn(*inputs), [t for t, n in zip(inputs, needs) if n],
                                         grad_out))
    return tuple(next(grads) if n else None for n in needs)


@torch.no_grad()
def perturb_params(generator: torch.Generator, embedders: dict, perturb_ratio: float = 0.2
                   ) -> dict:
    """Scale every leaf of every embedder by elementwise U(1 - r, 1 + r) noise,
    drawn from `generator` (on the leaves' device) in sorted placeholder order
    and field order. In place, so an optimizer holding the leaves keeps them;
    returns `embedders`. The numbers differ from the JAX package's
    (`jax.random` there), the distribution does not."""
    from adaface_tpu_torch.personalization.static_embedding import embedder_leaves

    for s in sorted(embedders):
        for _, t in embedder_leaves(embedders[s]):
            u = torch.rand(t.shape, generator=generator, device=t.device, dtype=torch.float32)
            t.mul_((1.0 - perturb_ratio + 2.0 * perturb_ratio * u).to(t.dtype))
    return embedders
