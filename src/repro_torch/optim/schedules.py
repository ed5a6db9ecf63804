"""Learning-rate schedules: plain functions of the step counter (an int
or a 0-d tensor), as in the reference's ``repro.optim.schedules``."""

from __future__ import annotations

import math

__all__ = ["warmup_cosine", "constant"]


def constant(lr: float):
    return lambda step: float(lr)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * peak_lr`` at ``total_steps`` (held after)."""
    def sched(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return peak_lr * step / max(warmup_steps, 1)
        prog = min(max((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return peak_lr * (final_frac + (1 - final_frac)
                          * 0.5 * (1 + math.cos(math.pi * prog)))
    return sched
