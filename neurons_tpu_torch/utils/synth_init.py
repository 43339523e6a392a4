"""Random weights of plausible scale, drawn from a seeded generator on the
parameters' own device.

Counterpart of neurons_tpu/utils/synth_init.py, for synthetic full-size
runs that measure wiring and speed, not numerics: Linear/Conv weights are
uniform at a lecun-normal-like scale (std 1/sqrt(fan_in)), biases zero,
1-D gains and norm scales one, other raw parameters (null embeddings,
learned queries, tables) uniform at std 1/sqrt(fan_in) of their
[..., in, out] layout. Zero-initialised heads get random weights too, so
no output is trivially zero.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def synth_params_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Overwrite every parameter of `module` in place; returns it."""
    gens = {}
    for mod_name, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
                continue
            if p.dim() <= 1:  # norm scales and gains
                p.fill_(1.0)
                continue
            if isinstance(mod, (nn.Linear, nn.Conv2d)) and name == "weight":
                fan_in = p[0].numel()
            else:
                fan_in = math.prod(p.shape[:-1])
            gen = gens.get(p.device)
            if gen is None:
                gen = gens[p.device] = torch.Generator(p.device)
                gen.manual_seed(seed)
            a = math.sqrt(3.0 / max(1, fan_in))
            p.copy_(torch.rand(p.shape, generator=gen, device=p.device,
                               dtype=p.dtype).mul_(2 * a).sub_(a))
    return module
