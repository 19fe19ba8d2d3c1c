"""LR schedules driven by the global collaboration step.

Copy of ``dedloc_tpu/optim/schedules.py``: pure functions of the optimizer
step, computed in float32 (numpy) as the JAX versions compute them. The
linear schedule also takes a 0-d tensor step (the guarded applies keep the
count on the card) and then computes the same float32 operations there,
so both forms give the same bits; the cosine schedule's tensor path
computes the numpy path's float32 operations with ``torch.cos``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dedloc_tpu_torch.utils.device import divide

Schedule = Callable[[int], float]
_f32 = np.float32


def linear_warmup_linear_decay(
    peak_lr: float, warmup_steps: int, total_steps: int
) -> Schedule:
    """transformers.get_linear_schedule_with_warmup equivalent."""

    def schedule(step):
        if isinstance(step, torch.Tensor):
            # divisors as 0-d tensors: IEEE divisions on CUDA too, where a
            # Python-number divisor becomes a reciprocal multiply
            s = step.to(torch.float32)
            const = lambda v: torch.full_like(s, float(_f32(v)))
            warm = s / const(max(1.0, warmup_steps))
            decay = torch.clamp_min(
                (const(total_steps) - s)
                / const(max(1.0, total_steps - warmup_steps)),
                0.0,
            )
            return float(_f32(peak_lr)) * torch.where(
                s < warmup_steps, warm, decay)
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

    def schedule(step):
        if isinstance(step, torch.Tensor):
            s = step.to(torch.float32)
            const = lambda v: torch.full_like(s, float(_f32(v)))
            warm = const(warmup_start_lr) + divide(
                (const(peak_lr) - const(warmup_start_lr)) * s,
                max(1.0, warmup_steps))
            progress = divide(s - const(warmup_steps),
                              max(1.0, total_steps - warmup_steps))
            progress = torch.clamp(progress, 0.0, 1.0)
            cos = const(eta_min) + (const(peak_lr) - const(eta_min)) * 0.5 * (
                1.0 + torch.cos(const(np.pi) * progress))
            return torch.where(s < warmup_steps, warm, cos)
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
