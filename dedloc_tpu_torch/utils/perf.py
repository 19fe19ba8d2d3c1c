"""Step-phase performance timers + profiler gate.

Capability of vissl's PerfTimer/PerfMetric/PerfStats (reference:
swav/vissl/vissl/utils/perf_stats.py:12-249) — context-manager timers wrapped
around every phase of the train step (read_sample / forward / loss_compute /
backward / optimizer_step, standard_train_step.py:110-226), aggregated and
reported periodically by a hook.

Port of ``dedloc_tpu/utils/perf.py``. Differences from the JAX package:
- a timer given ``block_on`` records a CUDA event after the step outputs
  and synchronises on it before stopping (``telemetry.steps.
  block_on_device``; the JAX package calls ``jax.block_until_ready``):
  kernels run async, so without the wait a timer around a launch measures
  dispatch, not execution.
- whole-program tracing goes through ``torch.profiler`` (a Chrome trace)
  behind one config flag, where the JAX package starts ``jax.profiler``.

Unified with the swarm-telemetry clock (docs/observability.md): PerfStats
times on ``telemetry.registry.monotonic_clock`` — real monotonic time in
production, FakeClock-offset-aware in fault scenarios — and, whenever a
telemetry registry is active (process-global or injected via
``telemetry=``), every block timing is ALSO observed into that registry's
``perf.<name>`` histogram. One clock source, one sink: the timings ride the
metrics-bus snapshot and the per-peer event trace instead of living only in
this object's private store (kept for the human ``report_str`` view and the
roles' recent-mean publishing).
"""
from __future__ import annotations

import math
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, Iterator, Optional

from dedloc_tpu_torch.telemetry import registry as _telemetry


class PerfMetric:
    """Online stats for one named phase: count/mean/min/max + recent window.

    Mirrors vissl PerfMetric (perf_stats.py:19-78): exact mean over all
    updates plus a smoothed recent-window mean for dashboards.
    """

    WINDOW = 32

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0
        self._recent: Deque[float] = deque(maxlen=self.WINDOW)

    def update(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.min = min(self.min, seconds)
        self.max = max(self.max, seconds)
        self._recent.append(seconds)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def recent_mean(self) -> float:
        return sum(self._recent) / len(self._recent) if self._recent else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "total_s": self.total,
            "mean_ms": self.mean * 1e3,
            "recent_ms": self.recent_mean * 1e3,
            "min_ms": (0.0 if self.count == 0 else self.min * 1e3),
            "max_ms": self.max * 1e3,
        }


class PerfStats:
    """Named collection of PerfMetrics with a human-readable report.

    Usage::

        stats = PerfStats()
        with stats.timer("forward", block_on=loss):
            loss = step(...)
    """

    def __init__(self, enabled: bool = True, telemetry=None) -> None:
        self.enabled = enabled
        self.metrics: Dict[str, PerfMetric] = {}
        # component-scoped telemetry registry; None resolves the process
        # global at each timing (so a registry installed AFTER this object
        # was built — the usual role startup order — still receives them)
        self._telemetry = telemetry

    def metric(self, name: str) -> PerfMetric:
        if name not in self.metrics:
            self.metrics[name] = PerfMetric()
        return self.metrics[name]

    @contextmanager
    def timer(self, name: str, block_on: Any = None) -> Iterator[None]:
        """Time a block. ``block_on``: tensors whose work is waited for
        (a synchronised CUDA event) before the clock stops."""
        if not self.enabled:
            yield
            return
        start = _telemetry.monotonic_clock()
        try:
            yield
        finally:
            if block_on is not None:
                from dedloc_tpu_torch.telemetry.steps import block_on_device

                block_on_device(block_on)
            # clamp at 0: a block straddling a FakeClock exit sees the
            # clock retreat by the whole fake offset
            dur = max(0.0, _telemetry.monotonic_clock() - start)
            self.metric(name).update(dur)
            tele = _telemetry.resolve(self._telemetry)
            if tele is not None:
                # the unified sink: the same timing rides the registry
                # (snapshot key ``perf.<name>.mean`` etc.)
                tele.histogram(f"perf.{name}").observe(dur)

    def report(self) -> Dict[str, Dict[str, float]]:
        return {name: m.summary() for name, m in sorted(self.metrics.items())}

    def report_str(self) -> str:
        lines = ["phase                      count   mean_ms  recent_ms    max_ms"]
        for name, m in sorted(self.metrics.items()):
            s = m.summary()
            lines.append(
                f"{name:<24} {s['count']:>7d} {s['mean_ms']:>9.2f}"
                f" {s['recent_ms']:>10.2f} {s['max_ms']:>9.2f}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.metrics.clear()


@contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Gate a ``torch.profiler`` trace behind one flag (§5 tracing
    requirement).

    ``log_dir`` falsy → no-op. Otherwise writes a Chrome trace of the
    wrapped region (host and, with a card, device activity) to
    ``log_dir/trace.json``.
    """
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
