"""Learning-rate schedule (``eegflow.train.schedule``): linear warmup then
cosine annealing, a function of the epoch:

    lambda(e) = (e+1)/warmup                                  for e < warmup
              = 0.5 (1 + cos(pi * (e-warmup)/(epochs-warmup)))  otherwise
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def warmup_cosine_schedule(base_lr: float, epochs: int, warmup_epochs: int,
                           updates_per_epoch: int) -> Callable[[int], float]:
    """LR of optimizer update ``step`` (0-based): the multiplier of epoch
    ``step // updates_per_epoch``, evaluated in float32 as the reference's
    jnp schedule is."""
    updates_per_epoch = max(1, updates_per_epoch)
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = int(step) // updates_per_epoch
        if epoch < warmup_epochs:
            mult = f32(epoch + 1.0) / f32(max(warmup_epochs, 1))
        else:
            progress = f32(epoch - warmup_epochs) / f32(max(epochs - warmup_epochs, 1))
            mult = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * progress))
        return float(f32(base_lr) * f32(mult))

    return schedule


def lr_trace(base_lr: float, epochs: int, warmup_epochs: int) -> np.ndarray:
    """Per-epoch LR values (the history's ``learning_rates``)."""
    out = []
    for e in range(epochs):
        if e < warmup_epochs:
            mult = (e + 1) / warmup_epochs
        else:
            progress = (e - warmup_epochs) / max(epochs - warmup_epochs, 1)
            mult = 0.5 * (1 + np.cos(np.pi * progress))
        out.append(base_lr * mult)
    return np.asarray(out)
