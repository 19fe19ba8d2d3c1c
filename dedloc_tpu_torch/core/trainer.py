"""Phase-loop trainer: hook dispatch around a train step.

Port of ``dedloc_tpu/core/trainer.py`` (vissl's SelfSupervisionTrainer +
standard_train_step capability): a phase (epoch) loop that pulls batches,
runs the train step, and dispatches cross-cutting hooks at defined points,
with per-phase perf timers around read_sample / step / hooks.

``step_fn`` is one opaque callable ``(state, batch) -> (state, metrics)``
(forward, loss, backward and optimizer together), so the in-step events
(on_forward/on_loss/on_backward/on_update) fire back-to-back after it
returns; they exist so reference-shaped hooks keep working. The loop waits
for the device work behind the loss (``telemetry.steps.block_on_device``)
and the host reads one scalar (the loss) per step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple

from dedloc_tpu_torch.core.hooks import HookList, LoopContext, default_hooks
from dedloc_tpu_torch.telemetry import steps
from dedloc_tpu_torch.telemetry.steps import StepRecorder, block_on_device
from dedloc_tpu_torch.utils.logging import get_logger
from dedloc_tpu_torch.utils.perf import PerfStats, profiler_trace

logger = get_logger(__name__)

StepFn = Callable[[Any, Any], Tuple[Any, Dict[str, Any]]]


class Trainer:
    """Generic phase-loop driver.

    ``step_fn(state, batch) -> (new_state, metrics)`` with ``metrics["loss"]``
    a device scalar; optional ``metrics["lr"]`` and ``metrics["global_step"]``
    flow into the hook context (the reference feeds the collaboration-wide
    optimizer step into its loss the same way, standard_train_step.py:153).
    """

    def __init__(
        self,
        step_fn: StepFn,
        hooks: Optional[HookList] = None,
        perf: Optional[PerfStats] = None,
        profiler_dir: Optional[str] = None,
        recorder: Optional[StepRecorder] = None,
    ):
        self.step_fn = step_fn
        self.hooks = hooks if hooks is not None else default_hooks()
        self.perf = perf if perf is not None else PerfStats()
        self.profiler_dir = profiler_dir
        # step-phase flight recorder (telemetry/steps.py): no-op while
        # telemetry is disabled; the default instance keeps call sites
        # unconditional
        self.recorder = recorder if recorder is not None else StepRecorder()

    def train(
        self,
        state: Any,
        batches: Iterator[Any],
        max_steps: int,
        steps_per_phase: Optional[int] = None,
        ctx: Optional[LoopContext] = None,
    ) -> Tuple[Any, LoopContext]:
        """Run up to ``max_steps`` steps, split into phases of
        ``steps_per_phase`` (one phase if None). Returns (state, ctx)."""
        steps_per_phase = steps_per_phase or max_steps
        ctx = ctx or LoopContext()
        ctx.max_steps = max_steps
        ctx.perf = self.perf
        ctx.train_state = state

        with profiler_trace(self.profiler_dir):
            self.hooks.dispatch("on_start", ctx)
            while ctx.local_step < max_steps and not ctx.should_stop:
                self.hooks.dispatch("on_phase_start", ctx)
                phase_end = min(ctx.local_step + steps_per_phase, max_steps)
                while ctx.local_step < phase_end and not ctx.should_stop:
                    state = self._one_step(state, batches, ctx)
                self.hooks.dispatch("on_phase_end", ctx)
                ctx.phase += 1
            self.hooks.dispatch("on_end", ctx)
        return state, ctx

    def _one_step(self, state: Any, batches: Iterator[Any], ctx: LoopContext):
        with self.recorder.step(step=ctx.local_step):
            return self._one_step_inner(state, batches, ctx)

    def _one_step_inner(self, state, batches, ctx):
        self.hooks.dispatch("on_step_begin", ctx)
        with self.perf.timer("read_sample"), steps.phase("data_wait"):
            try:
                batch = next(batches)
            except StopIteration:
                ctx.should_stop = True
                return state
        metrics: Dict[str, Any] = {}
        with self.perf.timer("train_step"), steps.phase("fwd_bwd"):
            state, metrics = self.step_fn(state, batch)
            # wait for the loss only — the rest of the state stays async
            loss = metrics.get("loss")
            if loss is not None:
                block_on_device(loss)
        ctx.local_step += 1
        ctx.train_state = state
        ctx.loss = float(metrics["loss"]) if "loss" in metrics else float("nan")
        if "lr" in metrics:
            ctx.lr = float(metrics["lr"])
        if "global_step" in metrics:
            ctx.global_step = int(metrics["global_step"])
        ctx.metrics = {
            k: float(v)
            for k, v in metrics.items()
            if k not in ("global_step",) and _is_scalar(v)
        }
        with self.perf.timer("hooks"), steps.phase("hooks"):
            # fused-step event fan-out (see module docstring)
            for event in ("on_forward", "on_loss", "on_backward", "on_update",
                          "on_step_end"):
                self.hooks.dispatch(event, ctx)
        return state


def _is_scalar(v: Any) -> bool:
    try:
        return getattr(v, "ndim", 0) == 0 or isinstance(v, (int, float))
    except Exception:
        return False
