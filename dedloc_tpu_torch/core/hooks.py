"""Training-loop hook pipeline.

Port of ``dedloc_tpu/core/hooks.py`` (the vissl/ClassyVision hook system's
capability: cross-cutting behaviour attached to well-defined points of the
train loop, dispatched over an ordered hook list). The same hooks and
events; ``DeviceStatsHook`` reads the card's allocator
(``torch.cuda.memory_allocated`` / ``max_memory_allocated``) and logs
nothing on the CPU.

The step function is one opaque call (forward, backward and optimizer
update together), so the in-step events fire back-to-back after it returns
with the same context. Work that must happen *inside* the step (prototype
renormalization, freeze-by-zeroing-grads, sinkhorn) lives in the step
functions (``models/swav.py``); hooks are the host-side seam.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

from dedloc_tpu_torch.utils.logging import get_logger
from dedloc_tpu_torch.utils.perf import PerfStats

logger = get_logger(__name__)

EVENTS = (
    "on_start",
    "on_phase_start",
    "on_step_begin",
    "on_forward",
    "on_loss",
    "on_backward",
    "on_update",
    "on_step_end",
    "on_phase_end",
    "on_end",
)


@dataclasses.dataclass
class LoopContext:
    """Mutable state threaded through every hook call.

    The hook-visible analogue of vissl's ``task`` object: current progress,
    last step's host-side metrics, and an extras dict for hook-to-hook
    communication (e.g. the trainer deposits the step's outputs here).
    """

    phase: int = 0
    local_step: int = 0
    global_step: int = 0
    loss: float = math.nan
    lr: float = math.nan
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    train_state: Any = None
    max_steps: Optional[int] = None
    perf: PerfStats = dataclasses.field(default_factory=PerfStats)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    should_stop: bool = False


class Hook:
    """Base hook: every event is a no-op. Subclass and override.

    Mirrors ClassyHook's function set (SSLClassyHookFunctions,
    vissl/hooks/__init__.py) with snake_case TPU-loop semantics.
    """

    def on_start(self, ctx: LoopContext) -> None: ...
    def on_phase_start(self, ctx: LoopContext) -> None: ...
    def on_step_begin(self, ctx: LoopContext) -> None: ...
    def on_forward(self, ctx: LoopContext) -> None: ...
    def on_loss(self, ctx: LoopContext) -> None: ...
    def on_backward(self, ctx: LoopContext) -> None: ...
    def on_update(self, ctx: LoopContext) -> None: ...
    def on_step_end(self, ctx: LoopContext) -> None: ...
    def on_phase_end(self, ctx: LoopContext) -> None: ...
    def on_end(self, ctx: LoopContext) -> None: ...


class HookList:
    """Ordered hook dispatch (vissl runs hooks in registration order)."""

    def __init__(self, hooks: Optional[List[Hook]] = None):
        self.hooks: List[Hook] = list(hooks or [])

    def add(self, hook: Hook) -> None:
        self.hooks.append(hook)

    def dispatch(self, event: str, ctx: LoopContext) -> None:
        if event not in EVENTS:
            raise ValueError(f"unknown hook event {event!r}; known: {EVENTS}")
        for hook in self.hooks:
            getattr(hook, event)(ctx)


class CheckNanLossHook(Hook):
    """Raise FloatingPointError on non-finite loss.

    Capability of vissl's CheckNanLossHook (state_update_hooks.py:207-233).
    The collaborative trainer additionally has state *rollback* on non-finite
    params (collaborative/optimizer.py NaN guard, run_trainer.py:134-137
    capability) — this hook is the fail-fast variant for the phase-loop
    trainer, where a NaN loss means the run is broken, not the averaging.
    """

    def on_loss(self, ctx: LoopContext) -> None:
        if not math.isfinite(ctx.loss):
            raise FloatingPointError(
                f"non-finite loss {ctx.loss} at local step {ctx.local_step}"
            )


class LogLossLrEtaHook(Hook):
    """Periodic progress log: loss, lr, steps/sec, ETA.

    Capability of vissl's LogLossLrEtaHook (log_hooks.py:114-209).
    """

    def __init__(self, log_every: int = 10):
        self.log_every = max(1, log_every)
        self._t0: Optional[float] = None
        self._step0 = 0

    def on_phase_start(self, ctx: LoopContext) -> None:
        self._t0 = time.perf_counter()
        self._step0 = ctx.local_step

    def on_step_end(self, ctx: LoopContext) -> None:
        if ctx.local_step % self.log_every:
            return
        rate = eta = float("nan")
        if self._t0 is not None:
            elapsed = time.perf_counter() - self._t0
            steps = max(ctx.local_step - self._step0, 1)
            rate = steps / max(elapsed, 1e-9)
            if ctx.max_steps:
                eta = (ctx.max_steps - ctx.local_step) / max(rate, 1e-9)
        logger.info(
            f"step {ctx.local_step}"
            + (f"/{ctx.max_steps}" if ctx.max_steps else "")
            + f" (global {ctx.global_step}): loss {ctx.loss:.4f}"
            + ("" if math.isnan(ctx.lr) else f" lr {ctx.lr:.3e}")
            + f" | {rate:.2f} steps/s"
            + ("" if math.isnan(eta) else f" eta {eta:.0f}s")
        )


class LogPerfMetricsHook(Hook):
    """Emit the PerfStats table every N steps and at phase end.

    Capability of vissl's LogPerfTimeMetricsHook (log_hooks.py:420-...).
    """

    def __init__(self, log_every: int = 100):
        self.log_every = max(1, log_every)

    def on_step_end(self, ctx: LoopContext) -> None:
        if ctx.perf.enabled and ctx.local_step % self.log_every == 0:
            logger.info("perf stats @ step %d\n%s", ctx.local_step, ctx.perf.report_str())

    def on_phase_end(self, ctx: LoopContext) -> None:
        if ctx.perf.enabled and ctx.perf.metrics:
            logger.info("perf stats @ phase %d end\n%s", ctx.phase, ctx.perf.report_str())


class DeviceStatsHook(Hook):
    """Periodic accelerator memory stats (vissl LogGpuStatsHook /
    LogGpuMemoryHook capability): the card's bytes in use and peak
    (``torch.cuda.memory_allocated`` / ``max_memory_allocated``) per local
    CUDA device. Without a card it logs nothing."""

    def __init__(self, log_every: int = 100):
        self.log_every = max(1, log_every)

    def on_step_end(self, ctx: LoopContext) -> None:
        if ctx.local_step % self.log_every:
            return
        import torch

        if not torch.cuda.is_available():
            return
        lines = []
        for i in range(torch.cuda.device_count()):
            in_use = torch.cuda.memory_allocated(i) / 2**30
            peak = torch.cuda.max_memory_allocated(i) / 2**30
            total = torch.cuda.get_device_properties(i).total_memory / 2**30
            lines.append(f"cuda:{i} {in_use:.2f}GiB in use, peak {peak:.2f}GiB"
                         f" / {total:.2f}GiB")
        logger.info(
            "device memory @ step %d: %s", ctx.local_step, " | ".join(lines),
        )


class CheckpointHook(Hook):
    """Periodic + phase-end checkpointing through a caller-provided save_fn.

    Capability of vissl's LogLossMetricsCheckpointHook (log_hooks.py:268-330):
    mid-phase saves every ``every`` steps (CHECKPOINT_ITER_FREQUENCY) and a
    save at every phase end. ``save_fn(ctx)`` owns layout/retention
    (utils/checkpoint.py provides both).
    """

    def __init__(self, save_fn: Callable[[LoopContext], None], every: int = 0):
        self.save_fn = save_fn
        self.every = every

    def on_step_end(self, ctx: LoopContext) -> None:
        if self.every and ctx.local_step and ctx.local_step % self.every == 0:
            self.save_fn(ctx)

    def on_phase_end(self, ctx: LoopContext) -> None:
        self.save_fn(ctx)


class MetricsPublisherHook(Hook):
    """Publish per-step metrics through a callback (DHT metrics bus seam).

    The phase-loop analogue of CollaborativeCallback.on_step_end publishing
    LocalMetrics to the DHT (albert/run_trainer.py:146-166): the trainer owns
    *what* to publish; this hook owns *when* (every global-step advance).
    """

    def __init__(self, publish_fn: Callable[[LoopContext], None]):
        self.publish_fn = publish_fn
        self._last_global = -1

    def on_step_end(self, ctx: LoopContext) -> None:
        if ctx.global_step != self._last_global:
            self._last_global = ctx.global_step
            self.publish_fn(ctx)


def default_hooks(
    log_every: int = 10,
    perf_log_every: int = 100,
    save_fn: Optional[Callable[[LoopContext], None]] = None,
    save_every: int = 0,
    device_stats_every: int = 0,
) -> HookList:
    """The standard pipeline (vissl default_hook_generator capability):
    NaN check → progress log → perf log → optional device-memory log →
    optional checkpointing."""
    hooks = HookList([CheckNanLossHook(), LogLossLrEtaHook(log_every),
                      LogPerfMetricsHook(perf_log_every)])
    if device_stats_every:
        hooks.add(DeviceStatsHook(device_stats_every))
    if save_fn is not None:
        hooks.add(CheckpointHook(save_fn, save_every))
    return hooks
