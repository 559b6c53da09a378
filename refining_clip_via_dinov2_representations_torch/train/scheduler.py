"""Learning-rate schedules as plain ``step -> lr`` functions.

The port of the JAX package's ``train/scheduler.py``. The optimizer sets
each param group's lr from the schedule before every step
(``train/optim.py:apply_schedule``): ``schedule(step) * group_lr / base_lr``,
or ``schedule(step)`` for every group under ``flatten_group_lrs`` (the
reference's bug-compatible behaviour).
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _warmup(base_lr: float, warmup_length: int, step: float) -> float:
    return base_lr * (step + 1.0) / max(1, warmup_length)


def const_lr(base_lr: float, warmup_length: int, steps: int) -> Schedule:
    def sched(step):
        return _warmup(base_lr, warmup_length, step) if step < warmup_length else base_lr

    return sched


def const_lr_cooldown(base_lr: float, warmup_length: int, steps: int, cooldown_steps: int,
                      cooldown_power: float = 1.0, cooldown_end_lr: float = 0.0) -> Schedule:
    """Constant, then a polynomial cooldown over the last ``cooldown_steps``."""
    start_cooldown = steps - cooldown_steps

    def sched(step):
        if step < warmup_length:
            return _warmup(base_lr, warmup_length, step)
        if step < start_cooldown:
            return base_lr
        e = step - start_cooldown
        es = max(1, steps - start_cooldown)
        decay = min(max(1.0 - e / es, 0.0), 1.0) ** cooldown_power
        return decay * (base_lr - cooldown_end_lr) + cooldown_end_lr

    return sched


def cosine_lr(base_lr: float, warmup_length: int, steps: int, lr_min: float = 0.0) -> Schedule:
    """Cosine decay to ``lr_min`` after a linear warm-up."""

    def sched(step):
        if step < warmup_length:
            return _warmup(base_lr, warmup_length, step)
        e = step - warmup_length
        es = max(1, steps - warmup_length)
        cosine_decay = 0.5 * (1.0 + math.cos(math.pi * min(max(e / es, 0.0), 1.0)))
        return lr_min + (base_lr - lr_min) * cosine_decay

    return sched


def make_schedule(args_like, base_lr: float, total_steps: int,
                  steps_per_epoch: int | None = None) -> Schedule:
    """The schedule the CLI flags name (``--lr-scheduler`` and its knobs)."""
    name = getattr(args_like, "lr_scheduler", "cosine")
    warmup = getattr(args_like, "warmup", 10000)
    if name == "cosine":
        return cosine_lr(base_lr, warmup, total_steps, getattr(args_like, "lr_min", 0.0))
    if name == "const":
        return const_lr(base_lr, warmup, total_steps)
    if name == "const-cooldown":
        epochs_cooldown = getattr(args_like, "epochs_cooldown", None)
        if epochs_cooldown is None:
            raise ValueError("Please specify the number of cooldown epochs for this lr schedule.")
        if steps_per_epoch is None:
            steps_per_epoch = total_steps // max(1, getattr(args_like, "epochs", 1))
        return const_lr_cooldown(
            base_lr, warmup, total_steps, steps_per_epoch * epochs_cooldown,
            getattr(args_like, "lr_cooldown_power", 1.0),
            getattr(args_like, "lr_cooldown_end", 0.0),
        )
    raise ValueError(f"Unknown scheduler {name!r}; options: cosine, const, const-cooldown")
