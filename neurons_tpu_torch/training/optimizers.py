"""Optimizer and learning-rate schedules of the trainers.

Counterpart of neurons_tpu/training/optimizers.py. The three schedules are
optax's formulas written out as plain functions of the step (they are not
torch's OneCycleLR or its warm-restart scheduler, whose phase boundaries
and step counts differ):

  cycle  — optax.cosine_onecycle_schedule(total, max_lr,
           pct_start=2/num_epochs, div_factor=25, final_div_factor=1000):
           cosine interpolation between the cumulative products of the
           scales at the boundaries
  linear — optax.linear_schedule(max_lr / 3 -> max_lr over total steps)
  cosine — optax.join_schedules of cosine decays over periods of 2, 4, 8,
           ... epochs (warm restarts)

The optimizer is torch.optim.AdamW over the trainable parameters only (the
frozen stage-1 core of stage 2 and the frozen `clipproj` of stage 1 never
enter it: the port's form of optax's set_to_zero mask, `freeze_by_prefix`);
its defaults (betas 0.9/0.999, eps 1e-8 outside the square root, bias
correction, decoupled weight decay) are optax.adamw's. Its state (step
count and both moments) is created with it, as optax's init creates it,
so a resume copies a checkpoint into it in place.
`optimizer_step` sets the learning rate from the schedule at each step and
clips by the global norm with optax's formula (no epsilon, unlike
torch.nn.utils.clip_grad_norm_).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

from neurons_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]


def _cosine_onecycle(transition_steps: int, peak_value: float,
                     pct_start: float, div_factor: float,
                     final_div_factor: float) -> Schedule:
    if transition_steps <= 0:
        raise ValueError("a onecycle schedule needs positive transition_steps")
    scales: Dict[int, float] = {
        int(pct_start * transition_steps): div_factor,
        int(transition_steps): 1.0 / (div_factor * final_div_factor)}
    bounds = [0] + sorted(scales)
    values = [peak_value / div_factor]
    for b in sorted(scales):
        values.append(values[-1] * scales[b])

    def schedule(count: int) -> float:
        out = 0.0
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                out += values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (
                    math.cos(math.pi * pct) + 1)
        if bounds[-1] <= count:
            out += values[-1]
        return out

    return schedule


def _linear(init_value: float, end_value: float,
            transition_steps: int) -> Schedule:
    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _cosine_decay(init_value: float, decay_steps: int) -> Schedule:
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init_value * 0.5 * (1 + math.cos(math.pi * count / decay_steps))

    return schedule


def _join(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return out

    return schedule


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Schedule:
    total = int(cfg.num_epochs * steps_per_epoch)
    if cfg.lr_scheduler_type == "cycle":
        return _cosine_onecycle(total, cfg.max_lr, 2 / cfg.num_epochs, 25.0,
                                1000.0)
    if cfg.lr_scheduler_type == "linear":
        return _linear(cfg.max_lr / 3, cfg.max_lr, total)
    if cfg.lr_scheduler_type == "cosine":
        schedules, boundaries = [], []
        period, start = 2 * steps_per_epoch, 0
        while start < total:
            schedules.append(_cosine_decay(cfg.max_lr, period))
            start += period
            boundaries.append(start)
            period *= 2
        return _join(schedules, boundaries[:-1])
    raise ValueError(cfg.lr_scheduler_type)


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.Tensor],
                   steps_per_epoch: int
                   ) -> Tuple[torch.optim.AdamW, Schedule]:
    """AdamW over `params` (the trainable ones) and its schedule."""
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    opt = torch.optim.AdamW(list(params), lr=schedule(0), betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay)
    for group in opt.param_groups:  # AdamW's own lazy init, done now
        for p in group["params"]:
            opt.state[p] = {"step": torch.tensor(0.0),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
    return opt, schedule


def freeze_by_prefix(prefixes: Sequence[str]) -> Callable[[str], bool]:
    """A predicate on dotted parameter names, true where one of the name's
    components is in `prefixes` (("clipproj",) freezes `clipproj.proj`,
    not `backbone.clip_proj.*`), as the JAX package's mask matches path
    components."""

    def frozen(name: str) -> bool:
        return any(p in name.split(".") for p in prefixes)

    return frozen


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm in place: g <- g * max_norm / ||g|| when
    the global norm ||g|| is not below max_norm. No host sync."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor)


def optimizer_step(opt: torch.optim.Optimizer, schedule: Schedule, step: int,
                   grad_clip: float = 0.0):
    """One update from the parameters' .grad: clip (grad_clip > 0), set the
    learning rate to schedule(step) (optax counts updates from 0), step."""
    if grad_clip > 0:
        clip_by_global_norm_([p.grad for g in opt.param_groups
                              for p in g["params"] if p.grad is not None],
                             grad_clip)
    lr = schedule(step)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
