"""Diffusion-training LR multiplier schedules.

Counterpart of neurons_tpu/diffusion/lr_schedule.py (the reference's sgm
LambdaWarmUpCosineScheduler, LambdaWarmUpCosineScheduler2 and
LambdaLinearScheduler). Each of the three returns a plain `step -> multiplier`
function, like the schedules of `training/optimizers.py`, computed in f32
as the JAX package computes it; use it with a base lr of 1.0 as the
reference says (or multiply a base lr by it).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np

Schedule = Callable[[int], float]
_PI = np.float32(math.pi)


def warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float,
                  lr_start: float, max_decay_steps: int) -> Schedule:
    """reference lr_scheduler.py:4-48 (one cycle)."""
    wu, lmin, lmax, lstart = (np.float32(v) for v in
                              (warm_up_steps, lr_min, lr_max, lr_start))
    mds = np.float32(max_decay_steps)

    def schedule(n: int) -> float:
        n = np.float32(n)
        if n < wu:
            return float((lmax - lstart) / wu * n + lstart)
        t = min((n - wu) / (mds - wu), np.float32(1.0))
        return float(lmin + np.float32(0.5) * (lmax - lmin)
                     * (np.float32(1) + np.cos(t * _PI)))

    return schedule


def _cycle_state(n: int, cycle_lengths: Sequence[int]) -> Tuple[int, int]:
    """(cycle index, step within the cycle), reference lr_scheduler.py:
    76-85. The reference's `n <= cum` boundary puts a cycle's last step in
    the earlier interval: searchsorted(side='left')."""
    cum = np.cumsum([0] + list(cycle_lengths))
    cycle = min(int(np.searchsorted(cum[1:], n, side="left")),
                len(cycle_lengths) - 1)
    return cycle, int(n - cum[cycle])


def _cyclic(warm_up_steps, f_min, f_max, f_start, cycle_lengths, tail):
    if not (len(warm_up_steps) == len(f_min) == len(f_max) == len(f_start)
            == len(cycle_lengths)):
        raise ValueError("the cyclic schedules take one value per cycle")
    wu, fmin, fmax, fstart, cl = (np.asarray(v, np.float32) for v in
                                  (warm_up_steps, f_min, f_max, f_start,
                                   cycle_lengths))

    def schedule(n: int) -> float:
        c, n_c = _cycle_state(n, cycle_lengths)
        n_c = np.float32(n_c)
        if n_c < wu[c]:
            return float((fmax[c] - fstart[c]) / wu[c] * n_c + fstart[c])
        return float(tail(n_c, wu[c], fmin[c], fmax[c], cl[c]))

    return schedule


def cyclic_warmup_cosine(warm_up_steps: Sequence[int],
                         f_min: Sequence[float], f_max: Sequence[float],
                         f_start: Sequence[float],
                         cycle_lengths: Sequence[int]) -> Schedule:
    """reference lr_scheduler.py:51-110 (repeated cycles)."""

    def cosine(n_c, wu, fmin, fmax, cl):
        t = min((n_c - wu) / (cl - wu), np.float32(1.0))
        return fmin + np.float32(0.5) * (fmax - fmin) * (
            np.float32(1) + np.cos(t * _PI))

    return _cyclic(warm_up_steps, f_min, f_max, f_start, cycle_lengths,
                   cosine)


def cyclic_warmup_linear(warm_up_steps: Sequence[int],
                         f_min: Sequence[float], f_max: Sequence[float],
                         f_start: Sequence[float],
                         cycle_lengths: Sequence[int]) -> Schedule:
    """reference lr_scheduler.py:113-135 LambdaLinearScheduler, the
    schedule SD training configs use."""

    def linear(n_c, wu, fmin, fmax, cl):
        return fmin + (fmax - fmin) * (cl - n_c) / cl

    return _cyclic(warm_up_steps, f_min, f_max, f_start, cycle_lengths,
                   linear)
