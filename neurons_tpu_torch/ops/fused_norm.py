"""GroupNorm and GroupNorm + SiLU on channels-first tensors, plain PyTorch.

Counterpart of neurons_tpu/ops/fused_norm.py. The statistics are two-pass:
the mean first, then the variance of the centred values (the single-pass
E[x^2] - mean^2 cancels for large-mean channels), both in f32 (f64 for f64
input); the result comes back in the input type. The JAX package's
fused Pallas kernels (GN+SiLU, GN+SiLU+conv) are opt-in there and off
stage 3's path; their CUDA ports are still to come (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _normalize_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float) -> torch.Tensor:
    n, c = x.shape[:2]
    acc = torch.promote_types(x.dtype, torch.float32)
    xg = x.to(acc).reshape(n, groups, -1)
    xc = xg - xg.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = (xc * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * weight.to(acc).reshape(shape) + bias.to(acc).reshape(shape)


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int,
                         eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (C/G, *spatial) of x [N, C, *spatial]."""
    return _normalize_f32(x, weight, bias, groups, eps).to(x.dtype)


def group_norm_silu_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, groups: int,
                              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm then SiLU, x [N, C, *spatial]."""
    return F.silu(_normalize_f32(x, weight, bias, groups, eps)).to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm with the JAX package's parameters (scale -> weight, bias)
    and its two-pass statistics. Input [N, C, *spatial]."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_reference(x, self.weight, self.bias,
                                    self.num_groups, self.eps)


class GroupNormSiLU(GroupNorm):
    """GroupNorm followed by SiLU, one module as in the JAX package."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu_reference(x, self.weight, self.bias,
                                         self.num_groups, self.eps)
