"""Training loss and DDPM sampling loop of the diffusion prior.

Counterpart of neurons_tpu/diffusion/prior.py: x0-prediction DDPM over the
CLIP image-token grid with a cosine schedule and cond-drop CFG training,
and ancestral sampling. The JAX `lax.scan` becomes a Python loop over the
timesteps. JAX's key splits become explicit draws: a `torch.Generator`, or
tensors passed in.
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


class PriorDraws(NamedTuple):
    """Explicit draws for `p_losses`: timesteps [B] (int64), the noise in
    the target's shape, and the keep masks [B] (bool; True keeps the row's
    condition) of the brain and image conditions."""

    times: torch.Tensor
    noise: torch.Tensor
    brain_keep: torch.Tensor
    image_keep: torch.Tensor


def draw_prior(diff: "PriorDiffusion", shape: Tuple[int, ...],
               generator: torch.Generator, device) -> PriorDraws:
    """t ~ U[0, T), standard-normal noise of `shape`, and a row keeps each
    condition where a uniform draw is >= the cond-drop probability."""
    b = shape[0]

    def keep():
        return torch.rand((b,), generator=generator,
                          device=device) >= diff.cond_drop_prob

    times = torch.randint(0, diff.schedule.num_timesteps, (b,),
                          generator=generator, device=device)
    noise = torch.randn(shape, generator=generator, device=device)
    return PriorDraws(times, noise, keep(), keep())


def p_losses(diff: PriorDiffusion, net: NetApply, image_embed: torch.Tensor,
             brain_embed: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[PriorDraws] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training loss: noise the CLIP target at t, predict x0 with cond-drop,
    MSE against the clean target. Returns (loss, pred); the prediction
    feeds the decoupler heads. The draws come from `draws`, or from
    `generator`."""
    if draws is None:
        if generator is None:
            raise ValueError("p_losses needs a generator or explicit draws")
        draws = draw_prior(diff, tuple(image_embed.shape), generator,
                           image_embed.device)
    noisy = sched_lib.q_sample(diff.schedule, image_embed, draws.times,
                               draws.noise.to(image_embed.dtype))
    pred = net(noisy, draws.times, brain_embed,
               brain_cond_drop_prob=diff.cond_drop_prob,
               image_cond_drop_prob=diff.cond_drop_prob,
               brain_keep=draws.brain_keep, image_keep=draws.image_keep)
    return torch.mean(torch.square(pred - image_embed)), pred


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
