"""Per-step flight recorder: in-situ hot-path attribution for the trainer.

Port of ``dedloc_tpu/telemetry/steps.py``. Two touchpoints differ: the MFU
gauge's peak comes from the CUDA card's name (``chip_peak_tflops``), and a
phase that must wait for the device (``block_on``) records a CUDA event on
the current stream and synchronises on it (``block_on_device``) where the
JAX package calls ``jax.block_until_ready``.

``tools/profile_albert.py`` answers "where do the cycles go" offline, by
marginal-cost ablation on an idle chip (docs/perf.md). This module answers
the *production* form of the question — "where did step N's wall-clock go,
on this peer, in this run" — by decomposing every training step into named
phases and publishing the breakdown through the existing telemetry registry
(events + histograms + gauges), so the coordinator's swarm-health fold and
``runlog_summary --steps`` can rank peers by phase skew without attaching a
profiler to a volunteer's box.

Canonical phases (docs/observability.md "Step-phase flight recorder"):

- ``data_wait``    host input-pipeline stall (``next(batches)``)
- ``h2d``          host→device batch transfer (``put_batch`` on a mesh)
- ``fwd_bwd``      accumulate dispatch + the boundary's wait on a CUDA
                   event (kernels run async — without the wait a timer
                   measures dispatch, not execution)
- ``grad_flatten`` launching the device-side flatten/quantize program (or,
                   on the legacy path, the per-leaf device_get + host
                   flatten of the mean grads — the jit↔host seam crossing)
- ``d2h_stream``   the EXPOSED remainder of the async device→host gradient
                   stream: the transfer overlaps matchmaking (and, in
                   overlap mode, accumulation), so this phase reads ~0
                   when the overlap works and grows when the link is the
                   bottleneck (averaging/device_flat.py)
- ``avg_wire``     the synchronous averaging round (matchmaking + wire),
                   net of the exposed D2H wait above
- ``opt_apply``    optimizer apply + NaN guard
- ``collab``       progress-tracker reads/reports (DHT overhead)

Phase names are open — instrumented code may record others — but the six
canonical ones are what the cross-peer skew views key on. Phases must be
DISJOINT (never nest two live phases): the whole point of the recorder is
that per-step phase sums track the step wall, so the residual
(``untimed_s``) measures what the instrumentation missed.

Design rules, mirroring ``registry.py``:

- **Zero overhead when disabled.** ``StepRecorder.step`` resolves the
  telemetry registry once; with telemetry off it yields ``None`` and sets
  no context, and the module-level ``phase()`` helper used by code that
  does not hold the recorder (the collaborative optimizer) is a contextvar
  load and one profiler check returning a shared no-op.
- **FakeClock-compatible.** All timing uses the registry's monotonic
  clock (``registry.monotonic_clock``), which advances with the FakeClock
  offset — fault-injection tests produce deterministic phase durations.
- **One event per phase plus one summary.** Each finished step emits a
  ``step.phase`` event per recorded phase and one ``step.record`` event
  carrying the full breakdown (wall, samples, per-phase seconds, untimed
  residual, dominant phase, online MFU); each phase also feeds the
  ``step.phase.<name>`` histogram so metrics-bus snapshots carry
  ``step.phase.<name>.mean`` for the coordinator's swarm-health fold.

**Device-trace regions.** ``region(name)`` names a stretch of host code
``dedloc.<name>`` in a ``torch.profiler`` trace, the same trace that holds
the device's kernels, so each kernel and each wait of the device can be
charged to the code that launched it. The port's training step is covered
by them (docs/observability.md "Device-trace regions"); a phase of the
recorder enters the region of its own name as well. With no profiler
recording, a region is one check and the shared no-op.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Deque, Dict, Iterator, Optional

import torch

from dedloc_tpu_torch.telemetry import registry

# the canonical phase set, in pipeline order — the cross-peer views key on
# these (tools/runlog_summary.py keeps a deliberate copy, _CANONICAL_PHASES,
# because the tool is stdlib-only; keep the two in sync)
PHASES = (
    "data_wait", "h2d", "fwd_bwd", "grad_flatten", "d2h_stream", "avg_wire",
    "opt_apply", "collab",
)

# bf16 dense peak TFLOP/s by CUDA device-name substring (NVIDIA's data
# sheet, H100 SXM; the same figure chip_smoke.py's bounds use)
GPU_PEAK_TFLOPS = (
    ("h100", 989.0),
)


def chip_peak_tflops() -> float:
    """Peak bf16 TFLOP/s of CUDA device 0, or 0.0 without a known card
    (MFU gauge omitted)."""
    try:
        if not torch.cuda.is_available():
            return 0.0
        kind = torch.cuda.get_device_name(0).lower()
    except Exception:  # noqa: BLE001 — telemetry must never kill training
        return 0.0
    for sub, peak in GPU_PEAK_TFLOPS:
        if sub in kind:
            return peak
    return 0.0


def block_on_device(block_on: Any) -> None:
    """Wait until the work producing ``block_on`` (a tensor, or a dict,
    list or tuple of them) has finished: record a CUDA event on the current
    stream after it and synchronise on that event. CPU tensors are already
    computed when the call returns, so they need no wait."""
    stack, on_card = [block_on], False
    while stack and not on_card:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            on_card = item.is_cuda
        elif isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
    if on_card:
        event = torch.cuda.Event()
        event.record()
        event.synchronize()


def albert_tflops_per_sample(cfg, seq: int, max_pred: int) -> float:
    """Analytic MODEL TFLOPs for one ALBERT fwd+bwd sample — the same
    matmul-only formula as bench.py's ``albert_train_flops_per_sample``
    (remat recompute excluded by convention), so the recorder's in-situ MFU
    gauge is directly comparable to the BENCH_r* ``mfu`` field."""
    h, i, s = cfg.hidden_size, cfg.intermediate_size, seq
    e, v = cfg.embedding_size, cfg.vocab_size
    per_token_layer = 8 * h * h + 4 * h * s + 4 * h * i
    fwd = cfg.num_hidden_layers * per_token_layer * s
    fwd += 2 * e * h * s
    fwd += max_pred * 2 * (h * e + e * v)
    fwd += 2 * h * 2
    return 3.0 * fwd / 1e12


class _StepContext:
    """The live step being recorded: a mutable phase ledger plus free-form
    attrs (``ctx.attrs["stepped"] = True``) merged into the final record."""

    __slots__ = ("phases", "attrs", "step", "samples", "_clock")

    def __init__(self, step: Optional[int], samples: int, clock) -> None:
        self.phases: Dict[str, float] = {}
        self.attrs: Dict[str, Any] = {}
        self.step = step
        self.samples = int(samples)
        self._clock = clock

    def add(self, name: str, seconds: float) -> None:
        """Credit ``seconds`` to phase ``name`` (accumulates — a phase may
        be entered many times per step, e.g. data_wait per micro-batch)."""
        self.phases[name] = self.phases.get(name, 0.0) + max(0.0, seconds)

    @contextmanager
    def phase(self, name: str, block_on: Any = None) -> Iterator[None]:
        """Time a region into phase ``name``. ``block_on``: tensors whose
        work is waited for before the clock stops (``block_on_device``:
        kernel launches return before the card has run them)."""
        with region(name):
            start = self._clock()
            try:
                yield
            finally:
                if block_on is not None:
                    block_on_device(block_on)
                self.add(name, self._clock() - start)


# the live step context (per-thread / per-task): instrumented code that does
# not hold the recorder — the collaborative optimizer's grad_flatten /
# avg_wire / opt_apply seams — attributes its phases through this
_CURRENT: contextvars.ContextVar[Optional[_StepContext]] = (
    contextvars.ContextVar("dedloc_step", default=None)
)


def current() -> Optional[_StepContext]:
    return _CURRENT.get()


# what a region is while no profiler records: one shared, reusable no-op
_NOOP = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled
# a RecordFunction guard entered from Python without dispatching an
# operator: it shows in the trace as a host operation, and a dispatch mode
# (the selective-checkpoint policy of a remat block) never sees it
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def region(name: str):
    """A context naming the host code it encloses ``dedloc.<name>`` in a
    ``torch.profiler`` trace while one records, where the device operations
    launched inside it can be charged to it; otherwise ``_NOOP``, after one
    check. Names stay within 24 characters, so a label cut at 64 keeps
    them whole."""
    if _profiler_enabled():
        return _RecordFunctionFast("dedloc." + name)
    return _NOOP


def in_region(name: str) -> Callable:
    """A decorator: every call of the function runs inside
    ``region(name)``."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with region(name):
                return fn(*args, **kwargs)

        return run

    return wrap


def phase(name: str, block_on: Any = None):
    """Module-level phase timer: times into the innermost live step record,
    or, when no step is being recorded, is the phase's ``region`` (one
    contextvar load and one check while no profiler records)."""
    ctx = _CURRENT.get()
    return ctx.phase(name, block_on) if ctx is not None else region(name)


def add(name: str, seconds: float) -> None:
    """Credit pre-measured seconds to the live step record (no-op when none
    is live) — for call sites that already hold a duration."""
    ctx = _CURRENT.get()
    if ctx is not None:
        ctx.add(name, seconds)


class StepRecorder:
    """Bounded ring of per-step phase breakdowns + an online MFU gauge.

    One recorder per trainer loop. ``model_tflops_per_sample`` and
    ``peak_tflops`` enable the MFU gauge (0 disables it — e.g. CPU smoke
    runs); throughput for the gauge is a ring-window mean (samples over
    recorded wall), so it tracks the same quantity the bench headline
    measures rather than a single noisy step.
    """

    def __init__(
        self,
        telemetry: Optional[registry.Telemetry] = None,
        model_tflops_per_sample: float = 0.0,
        peak_tflops: float = 0.0,
        ring: int = 256,
        mfu_window: int = 32,
    ) -> None:
        self.telemetry = telemetry
        self.model_tflops_per_sample = float(model_tflops_per_sample)
        self.peak_tflops = float(peak_tflops)
        self.records: Deque[Dict[str, Any]] = deque(maxlen=ring)
        self.mfu_window = int(mfu_window)

    @contextmanager
    def step(
        self, step: Optional[int] = None, samples: int = 0
    ) -> Iterator[Optional[_StepContext]]:
        """Record one training step. Yields the live ``_StepContext`` (or
        None with telemetry disabled — callers use the yielded value only
        behind an ``is not None`` check, the disabled path costs one
        resolve)."""
        tele = registry.resolve(self.telemetry)
        if tele is None:
            yield None
            return
        ctx = _StepContext(step, samples, tele.clock)
        token = _CURRENT.set(ctx)
        start = tele.clock()
        try:
            yield ctx
        finally:
            _CURRENT.reset(token)
            wall = max(0.0, tele.clock() - start)
            self._finish(tele, ctx, wall)

    # ------------------------------------------------------------- internal

    def _finish(
        self, tele: registry.Telemetry, ctx: _StepContext, wall: float
    ) -> None:
        phases = dict(ctx.phases)
        untimed = max(0.0, wall - sum(phases.values()))
        record: Dict[str, Any] = {
            "step": ctx.step,
            "samples": ctx.samples,
            "wall_s": wall,
            "phases": phases,
            "untimed_s": untimed,
            **ctx.attrs,
        }
        dominant = max(phases, key=phases.get) if phases else None
        if dominant is not None:
            record["dominant"] = dominant
        mfu = self._update_mfu(tele, record)
        if mfu is not None:
            record["mfu"] = mfu
        self.records.append(record)
        tele.histogram("step.wall").observe(wall)
        for name, dur in phases.items():
            tele.histogram(f"step.phase.{name}").observe(dur)
            tele.event("step.phase", phase=name, dur_s=dur, step=ctx.step)
        tele.event("step.record", dur_s=wall, **{
            k: v for k, v in record.items() if k != "wall_s"
        })

    def _update_mfu(self, tele, record) -> Optional[float]:
        if self.model_tflops_per_sample <= 0 or self.peak_tflops <= 0:
            return None
        # ``record`` is not in the ring yet — append before slicing so
        # mfu_window=1 means "this step only", not the whole ring
        recent = (list(self.records) + [record])[-self.mfu_window:]
        samples = sum(r["samples"] for r in recent)
        wall = sum(r["wall_s"] for r in recent)
        if samples <= 0 or wall <= 0:
            return None
        sps = samples / wall
        mfu = sps * self.model_tflops_per_sample / self.peak_tflops
        tele.gauge("step.samples_per_sec").set(sps)
        tele.gauge("step.mfu").set(mfu)
        return mfu
