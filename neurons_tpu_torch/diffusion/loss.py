"""Training-side diffusion loss and sigma sampling (sgm's
StandardDiffusionLoss with offset noise, DiscreteSampling, EDMSampling).

Counterpart of neurons_tpu/diffusion/loss.py. The JAX functions draw from
a key; here a sampler draws from a `torch.Generator`, and the loss takes
its sigmas, noise and offset noise as explicit tensors (JAX's draws in the
parity tests) or draws each that is not given from `generator`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from neurons_tpu_torch.diffusion.schedule import sd_sigmas


def discrete_sigma_sampler(num_idx: int = 1000):
    """DiscreteSampling: a uniform index into the legacy-DDPM sigma table,
    ascending (reference sigma_sampling.py:17-31)."""
    table = sd_sigmas(num_idx, append_zero=False).flip(0)

    def sample(n: int, generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
        dev = generator.device if generator is not None else device
        idx = torch.randint(0, num_idx, (n,), generator=generator,
                            device=dev)
        return table.to(idx.device)[idx]

    return sample


def edm_sigma_sampler(p_mean: float = -1.2, p_std: float = 1.2):
    """EDMSampling: lognormal sigma (reference sigma_sampling.py:5-14)."""

    def sample(n: int, generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
        dev = generator.device if generator is not None else device
        return torch.exp(p_mean + p_std * torch.randn(
            (n,), generator=generator, device=dev))

    return sample


def standard_diffusion_loss(denoise: Callable, x: torch.Tensor,
                            sigma_sampler=None, loss_type: str = "l2",
                            offset_noise_level: float = 0.0,
                            w_fn: Optional[Callable] = None,
                            sigmas: Optional[torch.Tensor] = None,
                            noise: Optional[torch.Tensor] = None,
                            offset: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """StandardDiffusionLoss (reference loss.py:59-105): noise `x` at the
    sampled sigmas (plus the per-sample offset noise), denoise, weighted
    pixel loss averaged per sample, then over the batch. `sigmas` [B],
    `noise` like x and `offset` [B, 1, ...] are drawn from `generator`
    (sigmas through `sigma_sampler`) where not given."""
    b = x.shape[0]
    if sigmas is None:
        sigmas = sigma_sampler(b, generator, x.device)
    sigmas = sigmas.to(x.device, x.dtype)
    sig_b = sigmas.reshape((-1,) + (1,) * (x.dim() - 1))
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
    if offset_noise_level > 0.0:
        if offset is None:
            offset = torch.randn((b,) + (1,) * (x.dim() - 1),
                                 generator=generator, device=x.device,
                                 dtype=x.dtype)
        noise = noise + offset_noise_level * offset
    pred = denoise(x + noise * sig_b, sigmas)
    w = w_fn(sigmas).reshape(sig_b.shape) if w_fn is not None else 1.0
    if loss_type == "l2":
        per = (w * (pred - x) ** 2).reshape(b, -1).mean(dim=1)
    elif loss_type == "l1":
        per = (w * (pred - x)).abs().reshape(b, -1).mean(dim=1)
    else:
        raise ValueError(loss_type)
    return per.mean()
