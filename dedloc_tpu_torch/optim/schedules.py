"""LR schedules driven by the global collaboration step.

Copy of ``dedloc_tpu/optim/schedules.py``: pure functions of the optimizer
step, computed in float32 (numpy) as the JAX versions compute them.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def linear_warmup_linear_decay(
    peak_lr: float, warmup_steps: int, total_steps: int
) -> Schedule:
    """transformers.get_linear_schedule_with_warmup equivalent."""

    def schedule(step) -> float:
        step = _f32(step)
        warm = step / _f32(max(1.0, warmup_steps))
        decay = max(
            _f32(0.0),
            (_f32(total_steps) - step) / _f32(max(1.0, total_steps - warmup_steps)),
        )
        return float(_f32(peak_lr) * (warm if step < warmup_steps else decay))

    return schedule


def linear_warmup_cosine_annealing(
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    warmup_start_lr: float = 0.0,
    eta_min: float = 0.0,
) -> Schedule:
    """LinearWarmupCosineAnnealingLR equivalent."""

    def schedule(step) -> float:
        step = _f32(step)
        if step < warmup_steps:
            warm = _f32(warmup_start_lr) + (
                _f32(peak_lr) - _f32(warmup_start_lr)
            ) * step / _f32(max(1.0, warmup_steps))
            return float(warm)
        progress = (step - _f32(warmup_steps)) / _f32(
            max(1.0, total_steps - warmup_steps)
        )
        progress = np.clip(progress, _f32(0.0), _f32(1.0))
        cos = _f32(eta_min) + (_f32(peak_lr) - _f32(eta_min)) * _f32(0.5) * (
            _f32(1.0) + np.cos(_f32(np.pi) * progress)
        )
        return float(cos)

    return schedule
