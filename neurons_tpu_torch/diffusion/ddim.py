"""DDIM scheduler (diffusers-equivalent), as precomputed tensors.

Counterpart of neurons_tpu/diffusion/ddim.py: SD's scaled-linear betas
(0.00085 -> 0.012), steps_offset 1, no sample clipping, eta 0.
`create(25)` gives timesteps [961, 921, ..., 1]. The tables are computed in
float64 numpy and stored as f32 tensors, as in the JAX package.
`ddim_inversion` runs the deterministic trajectory backward, clean to
noised.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import numpy as np
import torch

from neurons_tpu_torch.diffusion.schedule import linear_betas


class DDIMScheduler(NamedTuple):
    alphas_cumprod: torch.Tensor        # [T_train] f32
    timesteps: torch.Tensor             # [num_steps] int64, descending
    final_alpha_cumprod: torch.Tensor   # f32 scalar (1.0: set_alpha_to_one)
    num_train_timesteps: int

    @staticmethod
    def create(num_inference_steps: int, num_train_timesteps: int = 1000,
               beta_start: float = 0.00085, beta_end: float = 0.012,
               steps_offset: int = 1, set_alpha_to_one: bool = True,
               device="cpu") -> "DDIMScheduler":
        betas = linear_betas(num_train_timesteps, beta_start, beta_end)
        ac = np.cumprod(1.0 - betas)
        step_ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
        ts = ts.astype(np.int64) + steps_offset
        return DDIMScheduler(
            alphas_cumprod=torch.tensor(ac, dtype=torch.float32,
                                        device=device),
            timesteps=torch.tensor(ts.copy(), device=device),
            final_alpha_cumprod=torch.tensor(
                1.0 if set_alpha_to_one else ac[0], dtype=torch.float32,
                device=device),
            num_train_timesteps=num_train_timesteps)

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  t: Union[int, torch.Tensor]) -> torch.Tensor:
        """sqrt(abar_t) sample + sqrt(1 - abar_t) noise; t a step or [B]."""
        ac = self.alphas_cumprod[t]
        ac = ac.reshape(ac.shape + (1,) * (sample.dim() - ac.dim()))
        return torch.sqrt(ac) * sample + torch.sqrt(1 - ac) * noise

    def step(self, eps_pred: torch.Tensor, t: int,
             sample: torch.Tensor) -> torch.Tensor:
        """Deterministic DDIM step (eta 0, eps prediction, no clipping):
        x0 = (x - sqrt(1 - abar_t) eps) / sqrt(abar_t),
        x_prev = sqrt(abar_prev) x0 + sqrt(1 - abar_prev) eps."""
        t = int(t)
        prev_t = t - self.num_train_timesteps // self.timesteps.shape[0]
        abar_t = self.alphas_cumprod[t]
        abar_prev = (self.alphas_cumprod[prev_t] if prev_t >= 0
                     else self.final_alpha_cumprod)
        x0 = (sample - torch.sqrt(1 - abar_t) * eps_pred) / torch.sqrt(abar_t)
        return torch.sqrt(abar_prev) * x0 + torch.sqrt(1 - abar_prev) * eps_pred


def ddim_inversion(scheduler: DDIMScheduler,
                   eps_fn: Callable[[torch.Tensor, torch.Tensor],
                                    torch.Tensor],
                   latents: torch.Tensor, num_steps: int) -> torch.Tensor:
    """DDIM inversion over the first `num_steps` of the ascending
    timesteps: at each t, with prev_t = t - T // steps,
    x0 = (x - sqrt(1 - abar_prev) eps) / sqrt(abar_prev) and
    x <- sqrt(abar_t) x0 + sqrt(1 - abar_t) eps, where eps = eps_fn(x,
    t [B]). Returns the latent after the last step."""
    ts = scheduler.timesteps.flip(0).tolist()
    step_ratio = scheduler.num_train_timesteps // len(ts)
    x = latents
    for t in ts[:num_steps]:
        prev_t = t - step_ratio
        abar_t = scheduler.alphas_cumprod[t]
        abar_prev = (scheduler.alphas_cumprod[prev_t] if prev_t >= 0
                     else scheduler.final_alpha_cumprod)
        eps = eps_fn(x, torch.full((x.shape[0],), t, device=x.device))
        x0 = (x - torch.sqrt(1 - abar_prev) * eps) / torch.sqrt(abar_prev)
        x = torch.sqrt(abar_t) * x0 + torch.sqrt(1 - abar_t) * eps
    return x
