"""Learning-rate schedules as plain ``step -> lr`` functions.

Counterpart of ``transformers4rec_tpu/trainer/schedulers.py``: every name its
``get_scheduler`` takes, with the same values at every step (linear warm-up
from 0, then the decay; the cosine variants follow the Hugging Face
``num_cycles`` semantics). Steps count from 0. Restarting a schedule is
re-creating the optimizers (``Trainer.reset_lr_scheduler``).
"""

from __future__ import annotations

import math
from typing import Callable


def _polynomial(init: float, end: float, power: float, steps: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac ** power + end

    return schedule


def get_scheduler(
    name: str,
    learning_rate: float,
    num_warmup_steps: int,
    num_training_steps: int,
    num_cycles: float = 0.5,
    power: float = 1.0,
) -> Callable[[int], float]:
    name = name.lower()
    lr = float(learning_rate)
    warmup = max(int(num_warmup_steps), 0)
    total = max(int(num_training_steps), warmup + 1)
    decay_steps = max(total - warmup, 1)

    def constant(step: int) -> float:
        return lr

    if name == "constant":
        return constant
    if name == "constant_with_warmup":
        decay = constant
    elif name == "linear":
        decay = _polynomial(lr, 0.0, 1.0, decay_steps)
    elif name == "polynomial":
        decay = _polynomial(lr, 0.0, power, decay_steps)
    elif name == "cosine":
        def decay(step: int) -> float:
            progress = min(max(step / decay_steps, 0.0), 1.0)
            return lr * max(0.5 * (1.0 + math.cos(math.pi * 2.0 * num_cycles * progress)), 0.0)
    elif name == "cosine_with_restarts":
        cycles = int(max(num_cycles, 1))

        def decay(step: int) -> float:
            progress = min(max(step / decay_steps, 0.0), 1.0)
            if progress >= 1.0:
                return 0.0
            return lr * max(0.5 * (1.0 + math.cos(math.pi * ((cycles * progress) % 1.0))), 0.0)
    else:
        raise ValueError(f"Unknown scheduler {name!r}")
    if not warmup:
        return decay
    warm = _polynomial(0.0, lr, 1.0, warmup)
    # the decay's own step count starts where the warm-up ends
    return lambda step: warm(step) if step < warmup else decay(step - warmup)


def num_cosine_cycles(num_epochs: float, cycles_per_epoch: float) -> float:
    """``num_cycles = num_epochs * learning_rate_num_cosine_cycles_by_epoch``."""
    return num_epochs * cycles_per_epoch
