"""Progressive task-weight curriculum of stage 2.

Counterpart of neurons_tpu/training/curriculum.py: each of the four
decoupler tasks (key-object seg, multi-label cls, caption, blurry recon)
gets a sinusoidal loss weight 1 -> 10 -> 1 over a window of
`period = 2 * (num_epochs // 5)` epochs, task i's window starting at epoch
`i * period // 2`; outside its window a task's weight is 1.
"""

from __future__ import annotations

import math

import torch


def log_weight(epoch: int, batch: int, batches_per_epoch: int,
               start_epoch: int, period: int) -> float:
    total_batches = period * batches_per_epoch
    current_batch = (epoch - start_epoch) * batches_per_epoch + batch
    return 1.0 + 9.0 * abs(math.sin(current_batch / total_batches * math.pi))


def get_loss_weights(total_epochs: int, epoch: int, batch: int,
                     batches_per_epoch: int) -> torch.Tensor:
    """[4] f32 weights of the decoupler tasks at (epoch, batch). Under 5
    epochs no window fits and every weight is 1."""
    period = total_epochs // 5 * 2
    weights = []
    for i in range(4):
        start_epoch = i * period // 2
        in_window = period > 0 and start_epoch <= epoch < start_epoch + period
        weights.append(log_weight(epoch, batch, batches_per_epoch,
                                  start_epoch, period) if in_window else 1.0)
    return torch.tensor(weights, dtype=torch.float32)
