"""Per-step random generators, a function of (seed, epoch, step).

Counterpart of neurons_tpu/utils/prng.py:epoch_key: each training step
draws from a generator seeded from (seed, epoch, step) alone, so a run
resumed at an epoch boundary draws what an uninterrupted run draws there.
"""

from __future__ import annotations

import numpy as np
import torch


def step_seed(seed: int, epoch: int, step: int = 0) -> int:
    """A 63-bit seed mixed from (seed, epoch, step) by numpy's SeedSequence
    (stable across processes and versions)."""
    state = np.random.SeedSequence([seed, epoch, step]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def epoch_generator(seed: int, epoch: int, step: int = 0,
                    device="cpu") -> torch.Generator:
    """A generator on `device` seeded with step_seed(seed, epoch, step)."""
    return torch.Generator(device).manual_seed(step_seed(seed, epoch, step))


def stage_generator(seed: int, stage: str, start: int) -> torch.Generator:
    """The CPU generator of one generation batch: seeded from (seed, the
    stage's character, the batch's first clip), so the card and the CPU,
    and any batch size, draw the same noise for the same clip range."""
    return epoch_generator(seed, ord(stage), start)
