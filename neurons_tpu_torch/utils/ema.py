"""Exponential-moving-average shadow parameters.

Counterpart of neurons_tpu/utils/ema.py (the reference's LitEma): a dict of
shadow tensors keyed by the port's parameter names, updated with the decay
min(decay, (1 + n) / (10 + n)) taken in f32 as the JAX package takes it,
and swappable for inference (`ema_scope`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch


@dataclass
class EmaState:
    shadow: Dict[str, torch.Tensor]
    num_updates: int
    decay: float


def init(params: Mapping[str, torch.Tensor], decay: float = 0.9999
         ) -> EmaState:
    """A shadow copy of `params` ({name: tensor}, e.g. dict(module.
    named_parameters())), on their devices and in their dtypes."""
    with torch.no_grad():
        shadow = {k: v.detach().clone() for k, v in params.items()}
    return EmaState(shadow=shadow, num_updates=0, decay=decay)


def decay_at(num_updates: int, decay: float) -> torch.Tensor:
    """min(decay, (1 + n) / (10 + n)) as an f32 0-d tensor (on the host)."""
    n = torch.tensor(float(num_updates), dtype=torch.float32)
    return torch.minimum(torch.tensor(decay, dtype=torch.float32),
                         (1.0 + n) / (10.0 + n))


@torch.no_grad()
def update(state: EmaState, params: Mapping[str, torch.Tensor]) -> EmaState:
    """One EMA step in place: s <- s - (1 - d) (s - p). Returns `state`."""
    state.num_updates += 1
    one_minus = float(1.0 - decay_at(state.num_updates, state.decay))
    shadows = list(state.shadow.values())
    live = [params[k].detach().to(s.dtype) for k, s in state.shadow.items()]
    diffs = torch._foreach_sub(shadows, live)
    torch._foreach_mul_(diffs, one_minus)
    torch._foreach_sub_(shadows, diffs)
    return state


def swap(state: EmaState, params: Mapping[str, torch.Tensor]
         ) -> Tuple[Dict[str, torch.Tensor], Mapping[str, torch.Tensor]]:
    """The `ema_scope` enter: (the shadow parameters to run with, the live
    parameters to restore afterwards)."""
    return state.shadow, params
