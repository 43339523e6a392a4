"""Diffusion noise schedules as precomputed tensors.

Counterpart of neurons_tpu/diffusion/schedule.py: the cosine DDPM schedule
of the prior, the forward process q(x_t | x_0) and the posterior
q(x_{t-1} | x_t, x_0), the sigma ladder of sgm's LegacyDDPMDiscretization
used by the unCLIP sampler, and the EDM ladder of SVD. The tables are
computed in float64 numpy, then stored as f32 tensors, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class DDPMSchedule(NamedTuple):
    """Precomputed DDPM quantities, each [T]."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def cosine_betas(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0, 0.999)


def linear_betas(timesteps: int = 1000, beta_start: float = 0.00085,
                 beta_end: float = 0.012) -> np.ndarray:
    """SD "scaled linear": linear in sqrt(beta)."""
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5, timesteps,
                       dtype=np.float64) ** 2


def make_ddpm_schedule(betas: np.ndarray, device="cpu") -> DDPMSchedule:
    betas = np.asarray(betas, np.float64)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return DDPMSchedule(
        betas=t(betas),
        alphas_cumprod=t(ac),
        alphas_cumprod_prev=t(ac_prev),
        sqrt_alphas_cumprod=t(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=t(np.sqrt(1 - ac)),
        posterior_variance=t(post_var),
        posterior_log_variance_clipped=t(np.log(np.clip(post_var, 1e-20,
                                                        None))),
        posterior_mean_coef1=t(betas * np.sqrt(ac_prev) / (1 - ac)),
        posterior_mean_coef2=t((1 - ac_prev) * np.sqrt(alphas) / (1 - ac)),
        sqrt_recip_alphas_cumprod=t(np.sqrt(1 / ac)),
        sqrt_recipm1_alphas_cumprod=t(np.sqrt(1 / ac - 1)),
    )


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep scalars and broadcast to rank `ndim`."""
    out = arr[t]
    return out.reshape(out.shape + (1,) * (ndim - out.dim()))


def q_sample(sched: DDPMSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0)."""
    return (_extract(sched.sqrt_alphas_cumprod, t, x_start.dim()) * x_start
            + _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.dim())
            * noise)


def q_posterior(sched: DDPMSchedule, x_start: torch.Tensor,
                x_t: torch.Tensor, t: torch.Tensor):
    """Posterior q(x_{t-1} | x_t, x_0): (mean, variance, log_variance)."""
    mean = (_extract(sched.posterior_mean_coef1, t, x_t.dim()) * x_start
            + _extract(sched.posterior_mean_coef2, t, x_t.dim()) * x_t)
    var = _extract(sched.posterior_variance, t, x_t.dim())
    log_var = _extract(sched.posterior_log_variance_clipped, t, x_t.dim())
    return mean, var, log_var


def spaced_timesteps(num_substeps: int, max_step: int) -> np.ndarray:
    """Roughly equally spaced sub-timesteps, ascending."""
    return np.linspace(max_step - 1, 0, num_substeps,
                       endpoint=False).astype(int)[::-1]


def sd_sigmas(num_steps: int, timesteps: int = 1000,
              beta_start: float = 0.00085, beta_end: float = 0.012,
              append_zero: bool = True, device="cpu") -> torch.Tensor:
    """sigma_i = sqrt((1 - abar_i) / abar_i) at `num_steps` roughly equally
    spaced indices of the 1000-step scaled-linear schedule, descending,
    with a trailing 0 (the sampler convention). f32."""
    betas = linear_betas(timesteps, beta_start, beta_end)
    ac = np.cumprod(1.0 - betas)
    if num_steps < timesteps:
        ac = ac[spaced_timesteps(num_steps, timesteps)]
    elif num_steps != timesteps:
        raise ValueError(f"num_steps {num_steps} > table size {timesteps}")
    sigmas = np.sqrt((1 - ac) / ac)[::-1]
    if append_zero:
        sigmas = np.concatenate([sigmas, [0.0]])
    return torch.as_tensor(np.ascontiguousarray(sigmas, np.float32),
                           device=device)


def edm_sigmas(num_steps: int, sigma_min: float = 0.002,
               sigma_max: float = 80.0, rho: float = 7.0,
               append_zero: bool = True, device="cpu") -> torch.Tensor:
    """The EDM (Karras et al.) ladder: sigma_i = (max^(1/rho) + i/(n-1) *
    (min^(1/rho) - max^(1/rho)))^rho, descending, with a trailing 0. f32
    (computed in float64 numpy)."""
    ramp = np.linspace(0, 1, num_steps)
    min_r, max_r = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    sigmas = (max_r + ramp * (min_r - max_r)) ** rho
    if append_zero:
        sigmas = np.concatenate([sigmas, [0.0]])
    return torch.as_tensor(np.asarray(sigmas, np.float32), device=device)
