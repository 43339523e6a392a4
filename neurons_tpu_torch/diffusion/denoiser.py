"""EDM-preconditioned denoisers (sgm-equivalent).

Counterpart of neurons_tpu/diffusion/denoiser.py: the network is wrapped as
  D(x, sigma) = net(x * c_in, c_noise, cond) * c_out + x * c_skip
with the scalings of a prediction convention (eps, v, EDM).
`DiscreteDenoiser` snaps sigma to the nearest entry of the 1000-step DDPM
table and feeds its index as the timestep conditioning;
`ContinuousDenoiser` feeds the scaling's c_noise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from neurons_tpu_torch.diffusion.schedule import sd_sigmas


def eps_scaling(sigma: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(c_skip, c_out, c_in, c_noise) of an eps-prediction SD model."""
    c_skip = torch.ones_like(sigma)
    c_out = -sigma
    c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
    return c_skip, c_out, c_in, sigma


def v_scaling(sigma: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(c_skip, c_out, c_in, c_noise) of a v-prediction model."""
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
    c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
    return c_skip, c_out, c_in, sigma


def edm_scaling(sigma: torch.Tensor, sigma_data: float = 0.5
                ) -> Tuple[torch.Tensor, ...]:
    """(c_skip, c_out, c_in, c_noise) of Karras et al.'s preconditioning."""
    s2 = sigma ** 2 + sigma_data ** 2
    return (sigma_data ** 2 / s2, sigma * sigma_data / torch.sqrt(s2),
            1.0 / torch.sqrt(s2), 0.25 * torch.log(sigma))


class DiscreteDenoiser(NamedTuple):
    """sigmas: the table ascending by timestep index."""

    sigmas: torch.Tensor
    scaling: Callable = eps_scaling

    @staticmethod
    def create_sd(num_idx: int = 1000, scaling: Callable = eps_scaling,
                  device="cpu") -> "DiscreteDenoiser":
        table = sd_sigmas(num_idx, append_zero=False, device=device).flip(0)
        return DiscreteDenoiser(sigmas=table, scaling=scaling)

    def sigma_to_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        return torch.argmin((sigma[..., None] - self.sigmas).abs(), dim=-1)

    def __call__(self, network, x: torch.Tensor, sigma: torch.Tensor,
                 **cond) -> torch.Tensor:
        """x: [B, ...], sigma: [B]."""
        idx = self.sigma_to_idx(sigma)
        sigma_q = self.sigmas[idx].reshape((-1,) + (1,) * (x.dim() - 1))
        c_skip, c_out, c_in, _ = self.scaling(sigma_q)
        return (network(x * c_in, idx.float(), **cond) * c_out
                + x * c_skip)


class ContinuousDenoiser(NamedTuple):
    """The plain denoiser (no quantization) of EDM-style models."""

    scaling: Callable = eps_scaling

    def __call__(self, network, x: torch.Tensor, sigma: torch.Tensor,
                 **cond) -> torch.Tensor:
        """x: [B, ...], sigma: [B]."""
        bshape = sigma.shape + (1,) * (x.dim() - sigma.dim())
        c_skip, c_out, c_in, c_noise = self.scaling(sigma.reshape(bshape))
        return (network(x * c_in, c_noise.reshape(sigma.shape), **cond)
                * c_out + x * c_skip)
