"""LR schedules (port of ``repro/optim/schedule.py``): plain functions of
the 1-based step count returning a Python float."""
from __future__ import annotations

import math


def constant(value: float):
    return lambda step: float(value)


def cosine_with_warmup(peak: float, warmup: int, total: int, floor: float = 0.0):
    def sched(step) -> float:
        step = float(step)
        if step < warmup:
            return peak * step / max(1.0, warmup)
        prog = min(max((step - warmup) / max(1.0, total - warmup), 0.0), 1.0)
        return floor + 0.5 * (peak - floor) * (1.0 + math.cos(math.pi * prog))

    return sched
