"""Diffusion noise schedules and DDIM sub-schedules (host-side numpy).

Counterpart of `adaface_tpu/ops/schedule.py`: the same float64 derivation,
stored as float32 arrays. The samplers loop over the per-step constants in
Python, so they stay on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 8.5e-4,
                       linear_end: float = 1.2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """float64 betas: "linear" (a linspace in sqrt space, squared; SD v1.5),
    "cosine" (clipped to [0, 0.999]), "sqrt_linear" (a plain linspace) or
    "sqrt" (its square root)."""
    if schedule == "linear":
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                           dtype=np.float64) ** 2
    if schedule == "cosine":
        t = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(t / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1.0 - alphas[1:] / alphas[:-1], 0.0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"unknown beta schedule {schedule!r}")


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        method: str = "uniform") -> np.ndarray:
    """DDIM timestep indices with the reference's +1 offset, clipped below
    num_ddpm: "uniform" strides ([1, 21, ..., 981] for 50 of 1000), "quad"
    squares a linspace to sqrt(0.8 T) and truncates (`.astype(int)`)."""
    if method == "uniform":
        steps = np.arange(0, num_ddpm_timesteps, num_ddpm_timesteps // num_ddim_timesteps)
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps)
                 ** 2).astype(int)
    else:
        raise ValueError(f"unknown ddim discretization {method!r}")
    return np.unique(np.minimum(steps + 1, num_ddpm_timesteps - 1))


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Full-resolution (T=1000) schedule constants, float32 [T] arrays (the
    square roots taken in float64, as the JAX package does)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
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
    sigmas: np.ndarray  # [S], zero when eta = 0
    guidance_scales: np.ndarray  # [S]
    num_steps: int = 50


def make_diffusion_schedule(num_timesteps: int = 1000, schedule: str = "linear",
                            linear_start: float = 8.5e-4, linear_end: float = 1.2e-2,
                            cosine_s: float = 8e-3) -> DiffusionSchedule:
    betas = make_beta_schedule(schedule, num_timesteps, linear_start, linear_end, cosine_s)
    acp = np.cumprod(1.0 - betas)
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return DiffusionSchedule(betas=f32(betas), alphas_cumprod=f32(acp),
                             alphas_cumprod_prev=f32(np.append(1.0, acp[:-1])),
                             sqrt_alphas_cumprod=f32(np.sqrt(acp)),
                             sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
                             sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
                             sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
                             num_timesteps=num_timesteps)


def make_ddim_schedule(base: DiffusionSchedule, num_ddim_steps: int, eta: float = 0.0,
                       guidance_scale=(10.0, 4.0), method: str = "uniform") -> DDIMSchedule:
    """Per-step DDIM constants. sigma_i = eta sqrt((1 - a_prev) / (1 - a)
    (1 - a / a_prev)). `guidance_scale` is a (max, min) pair or a scalar s,
    which anneals s -> min(2, s); the scale at step i is a linspace over
    sampling order (`adaface_tpu/ops/schedule.py:137-182`)."""
    ddim_ts = make_ddim_timesteps(num_ddim_steps, base.num_timesteps, method)
    num_ddim_steps = len(ddim_ts)  # a uniform stride can give more steps than asked
    acp = np.asarray(base.alphas_cumprod, dtype=np.float64)
    alphas = acp[ddim_ts]
    alphas_prev = np.concatenate([[acp[0]], alphas[:-1]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
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
        sigmas=f32(sigmas[rev]),
        guidance_scales=f32(np.linspace(gmax, gmin, num_ddim_steps)),
        num_steps=num_ddim_steps,
    )
