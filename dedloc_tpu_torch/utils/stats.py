"""Tiny shared statistics helpers.

One definition of the nearest-rank percentile, used by the simulator's
sizing reports AND the digital-twin fitter: the twin's fidelity numbers
are only like-for-like because both sides compute the identical
statistic, so there must be exactly one implementation to drift.
"""
from __future__ import annotations

from typing import List


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation surprises
    across numpy versions); 0.0 on empty input."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[rank]


def median(values: List[float], default: float = 0.0) -> float:
    """Upper median (nearest-rank at q=0.5), ``default`` on empty input."""
    if not values:
        return default
    ordered = sorted(values)
    return ordered[len(ordered) // 2]
