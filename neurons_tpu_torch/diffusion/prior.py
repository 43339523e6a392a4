"""DDPM sampling loop of the diffusion prior.

Counterpart of neurons_tpu/diffusion/prior.py (inference part):
x0-prediction DDPM over the CLIP image-token grid with a cosine schedule,
ancestral sampling. The JAX `lax.scan` becomes a Python loop over the
timesteps.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from neurons_tpu_torch.diffusion import schedule as sched_lib
from neurons_tpu_torch.diffusion.schedule import DDPMSchedule

# net(image_embed, times, brain_embed, **kw) -> pred_x0
NetApply = Callable[..., torch.Tensor]


class PriorDiffusion(NamedTuple):
    schedule: DDPMSchedule
    cond_drop_prob: float = 0.2

    @staticmethod
    def create(timesteps: int = 100, cond_drop_prob: float = 0.2,
               device="cpu") -> "PriorDiffusion":
        return PriorDiffusion(
            schedule=sched_lib.make_ddpm_schedule(
                sched_lib.cosine_betas(timesteps), device=device),
            cond_drop_prob=cond_drop_prob)


class PriorNoise(NamedTuple):
    """Explicit draws for `p_sample_loop`: the initial sample, and the
    ancestral noise of timestep t at `steps[t]`."""

    init: torch.Tensor
    steps: Sequence[torch.Tensor]


def p_sample_loop(diff: PriorDiffusion, net: NetApply,
                  shape: Tuple[int, ...], brain_embed: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[PriorNoise] = None) -> torch.Tensor:
    """Ancestral DDPM sampling, without CFG (cond_scale 1, the stage-3
    setting). Per step: pred_x0 from the net, the posterior mean and
    log-variance, x_{t-1} = mean + [t>0] * exp(0.5 logvar) * eps. The noise
    comes from `generator`, or from `noise` when given. f32 state on
    brain_embed's device."""
    s = diff.schedule
    device = brain_embed.device

    def normal():
        return torch.randn(shape, generator=generator, device=device)

    x = noise.init.to(device, torch.float32) if noise is not None else normal()

    for t in range(s.num_timesteps - 1, -1, -1):
        times = torch.full((shape[0],), t, dtype=torch.int64, device=device)
        x_start = net(x, times, brain_embed)
        mean, _, log_var = sched_lib.q_posterior(s, x_start, x, times)
        eps = (noise.steps[t].to(device, torch.float32) if noise is not None
               else normal())
        x = mean + float(t > 0) * torch.exp(0.5 * log_var) * eps
    return x
