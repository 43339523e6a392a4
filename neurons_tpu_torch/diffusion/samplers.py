"""The EulerEDM sampler (sgm-equivalent), exact deterministic path.

Counterpart of neurons_tpu/diffusion/samplers.py:sample_euler with
s_churn=0 (the unclip6 setting): d = (x - D(x, sigma)) / sigma,
x <- x + (sigma_next - sigma) * d. Sigma ladders are descending with a
trailing 0. The encoder-reuse, TGATE, PAB and other sampler variants are
later work.
"""

from __future__ import annotations

from typing import Callable

import torch

# denoise(x, sigma_batch) -> denoised x0 estimate (conditioning closed over)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def prepare_noise(x: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """x *= sqrt(1 + sigma_0^2)."""
    return x * torch.sqrt(1.0 + sigmas[0] ** 2)


def sample_euler(denoise: DenoiseFn, x: torch.Tensor, sigmas: torch.Tensor,
                 prepare: bool = True) -> torch.Tensor:
    if prepare:
        x = prepare_noise(x, sigmas)
    for i in range(sigmas.shape[0] - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        denoised = denoise(x, sigma.expand(x.shape[0]).to(x.dtype))
        d = (x - denoised) / torch.clamp(sigma, min=1e-9)
        x = x + (sigma_next - sigma) * d
    return x
