"""Diffusion noise schedules and DDIM sub-schedules (host-side numpy).

Counterpart of `adaface_tpu/ops/schedule.py`: the same float64 derivation,
stored as float32 arrays. The sampler loops over the per-step constants in
Python, so they stay on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int) -> np.ndarray:
    """Uniform-stride DDIM timestep indices with the reference's +1 offset:
    [1, 21, ..., 981] for 50 of 1000 (clipped below num_ddpm)."""
    steps = np.arange(0, num_ddpm_timesteps, num_ddpm_timesteps // num_ddim_timesteps)
    return np.unique(np.minimum(steps + 1, num_ddpm_timesteps - 1))


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Full-resolution (T=1000) schedule constants, float32 [T] arrays (the
    square roots taken in float64, as the JAX package does)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    num_timesteps: int = 1000

    def _at(self, table: np.ndarray, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """table[t] shaped [B, 1, ...] to broadcast against `like`."""
        shape = (-1,) + (1,) * (like.dim() - 1)
        return torch.as_tensor(table, device=like.device)[t.long().to(like.device)].view(shape)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Forward noising q(x_t | x_0) = sqrt(acp_t) x_0 + sqrt(1 - acp_t)
        noise, for t [B] int."""
        return (self._at(self.sqrt_alphas_cumprod, t, x_start) * x_start
                + self._at(self.sqrt_one_minus_alphas_cumprod, t, x_start) * noise)

    def predict_x0_from_eps(self, x_t: torch.Tensor, t: torch.Tensor,
                            eps: torch.Tensor) -> torch.Tensor:
        """The x_0 estimate of an eps prediction, sqrt(1/acp_t) x_t -
        sqrt(1/acp_t - 1) eps."""
        return (self._at(self.sqrt_recip_alphas_cumprod, t, x_t) * x_t
                - self._at(self.sqrt_recipm1_alphas_cumprod, t, x_t) * eps)


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-DDIM-step constants in sampling order (index 0 = highest t);
    guidance anneals linearly max -> min over the steps."""

    timesteps: np.ndarray  # [S] int32, descending
    alphas: np.ndarray  # [S] float32 alpha_cumprod at each step
    alphas_prev: np.ndarray  # [S] alpha_cumprod at the next (lower-t) step
    sqrt_one_minus_alphas: np.ndarray  # [S]
    guidance_scales: np.ndarray  # [S]
    num_steps: int = 50


def make_diffusion_schedule(num_timesteps: int = 1000, linear_start: float = 8.5e-4,
                            linear_end: float = 1.2e-2) -> DiffusionSchedule:
    """SD v1.5's "linear" schedule: betas a linspace in sqrt space, squared."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, num_timesteps,
                        dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    return DiffusionSchedule(betas=betas.astype(np.float32),
                             alphas_cumprod=acp.astype(np.float32),
                             sqrt_alphas_cumprod=np.sqrt(acp).astype(np.float32),
                             sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acp).astype(np.float32),
                             sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp).astype(np.float32),
                             sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1.0).astype(
                                 np.float32),
                             num_timesteps=num_timesteps)


def make_ddim_schedule(base: DiffusionSchedule, num_ddim_steps: int,
                       guidance_scale=(10.0, 4.0)) -> DDIMSchedule:
    """Per-step constants of deterministic (eta = 0) DDIM. `guidance_scale` is a (max, min) pair or a scalar
    s, which anneals s -> min(2, s); the scale at step i is a linspace over
    sampling order (`adaface_tpu/ops/schedule.py:137-182`)."""
    ddim_ts = make_ddim_timesteps(num_ddim_steps, base.num_timesteps)
    num_ddim_steps = len(ddim_ts)  # a uniform stride can give more steps than asked
    acp = np.asarray(base.alphas_cumprod, dtype=np.float64)
    alphas = acp[ddim_ts]
    alphas_prev = np.concatenate([[acp[0]], alphas[:-1]])
    if isinstance(guidance_scale, (list, tuple)):
        gmax, gmin = float(guidance_scale[0]), float(guidance_scale[1])
    else:
        gmax = float(guidance_scale)
        gmin = min(2.0, gmax)
    rev = slice(None, None, -1)
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DDIMSchedule(
        timesteps=np.asarray(ddim_ts[rev], dtype=np.int32),
        alphas=f32(alphas[rev]),
        alphas_prev=f32(alphas_prev[rev]),
        sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas[rev])),
        guidance_scales=f32(np.linspace(gmax, gmin, num_ddim_steps)),
        num_steps=num_ddim_steps,
    )
