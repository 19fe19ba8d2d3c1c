"""Process-local swarm telemetry: counters/gauges/histograms + span tracing.

DeDLOC's operational reality is a fleet of unreliable volunteer peers — the
operator's only lever is knowing WHICH peer is stalling a round. The
reference leans on hivemind's logs plus a wandb dashboard; the step-phase
half lives in ``utils/perf.py`` (vissl PerfStats capability). This module is
the collaborative-machinery half: structured counters and span traces on the
hot seams (DHT RPCs, matchmaking, allreduce rounds, state-sync retries,
ramp/gate decisions, injected faults), written to a per-peer JSONL event log
and periodically snapshotted onto the signed DHT metrics bus
(``collaborative/metrics.py``) so the coordinator can aggregate swarm health
(``telemetry/health.py``).

Design rules, mirroring ``testing/faults.py``:

- **Zero overhead when disabled.** Instrumented code checks the module-level
  ``_active`` attribute (one load + identity test) before touching anything;
  production with telemetry off pays exactly that. Nothing here imports jax.
- **Scoped or global.** Production runs one peer per process, so the roles
  install ONE process-global registry (``install``/``configure``). In-process
  multi-peer tests pass a per-peer ``Telemetry`` instance into the components
  (averager/optimizer/matchmaking/protocol accept ``telemetry=``) so events
  and counters attribute to the right simulated peer; components fall back to
  the global registry when no instance was given (``resolve``).
- **FakeClock-compatible.** Timestamps are ``get_dht_time()`` (scenario time:
  deterministic under ``testing.faults.FakeClock``); span durations use a
  monotonic clock that also advances with the fake-clock offset, so fault
  scenarios replay to deterministic traces and production durations never go
  backwards on an NTP step.

Event-log schema (one JSON object per line; see docs/observability.md):

    {"t": <dht time>, "peer": "<label>", "event": "<name>",
     "dur_s": <float, spans only>, ...site-specific attributes}
"""
from __future__ import annotations

import contextvars
import hashlib
import json
import math
import threading
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Tuple

from dedloc_tpu_torch.core import timeutils
from dedloc_tpu_torch.core.timeutils import get_dht_time


def monotonic_clock() -> float:
    """Monotonic duration clock that also honours the FakeClock offset and
    a simulator-installed virtual time source: ``FakeClock.advance(n)``
    moves it forward by ``n`` exactly, so scripted fault scenarios produce
    deterministic span durations, while production (offset 0, no source)
    gets plain ``time.monotonic``. Alias of ``timeutils.monotonic`` — kept
    as the registry's public name for clock injection."""
    return timeutils.monotonic()


# ---------------------------------------------------------------------------
# Cross-peer trace context (docs/observability.md "trace propagation").
#
# A trace context is ``(trace_id, span_id, peer_label, remote)``: the trace a
# region belongs to, the span that is its parent, whose registry opened that
# span, and whether the parent lives on ANOTHER peer (adopted off the RPC
# framing's compact ``tc`` field). Spans push themselves onto the contextvar
# for their duration, so nested spans — and RPC requests issued inside them —
# inherit the linkage; server-side dispatch adopts the caller's context
# around the handler, so serve spans record their REMOTE parent and the
# coordinator can stitch per-peer JSONL into one causal round trace.
#
# The contextvar is per-task on the event loop and per-thread elsewhere, so
# concurrent rounds / concurrent handler tasks never cross-link. All of this
# is only ever touched behind a ``tele is not None`` check: telemetry off
# pays nothing and the wire framing carries zero extra bytes.
# ---------------------------------------------------------------------------

_TRACE: contextvars.ContextVar[Optional[Tuple[str, str, str, bool]]] = (
    contextvars.ContextVar("dedloc_trace", default=None)
)


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def trace_id_for(seed: str) -> str:
    """Deterministic trace id from a swarm-unique seed (the round_id): every
    peer of a round derives the SAME trace id without any wire handshake, so
    their spans stitch even when a hop's context never propagated (dead
    leader, dropped frame)."""
    return hashlib.sha1(seed.encode()).hexdigest()[:16]


def current_trace() -> Optional[Tuple[str, str, str, bool]]:
    """(trace_id, span_id, peer, remote) of the innermost live span, or
    None. ``RPCClient.call`` reads this to build the frame's ``tc`` field."""
    return _TRACE.get()


@contextmanager
def adopt_trace(tc) -> Iterator[None]:
    """Adopt a remote caller's trace context (the ``tc`` list off an RPC
    request frame: ``[trace_id, parent_span_id, caller_peer]``) for the
    duration of the handler — spans opened inside record the remote parent.
    Malformed ``tc`` values are ignored: a hostile or legacy peer must not
    be able to crash the dispatch path."""
    try:
        trace_id, parent_span, caller = (
            str(tc[0]), str(tc[1]), str(tc[2]) if len(tc) > 2 else "",
        )
    except (TypeError, IndexError, KeyError):
        yield
        return
    token = _TRACE.set((trace_id, parent_span, caller, True))
    try:
        yield
    finally:
        _TRACE.reset(token)


class Counter:
    """Monotonically-increasing float (events, bytes, failures). ``lock``
    is the owning registry's: ``+=`` is a non-atomic load/add/store in
    CPython and counters are hit from the trainer thread AND DHT loop
    threads concurrently — unlocked increments silently undercount."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock) -> None:
        self.value = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins scalar (queue depths, weight scales)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock) -> None:
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Online duration/size stats: count/total/min/max + recent window
    (the PerfMetric shape, utils/perf.py, minus the jax blocking)."""

    WINDOW = 64

    __slots__ = ("count", "total", "min", "max", "_recent", "_lock")

    def __init__(self, lock: threading.Lock) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0
        self._recent: Deque[float] = deque(maxlen=self.WINDOW)
        self._lock = lock

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self._recent.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "mean": self.mean,
            "min": 0.0 if not self.count else self.min,
            "max": self.max,
        }


def _jsonable(v: Any) -> Any:
    """Event attributes must serialize: keep scalars, stringify the rest
    (endpoints, peer ids, exceptions) so a fault-context object can never
    crash the telemetry path."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, bytes):
        return v.hex()[:16]
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


class Telemetry:
    """One peer's telemetry registry: named counters/gauges/histograms plus
    a bounded in-memory event trace, optionally mirrored to a JSONL file.

    Thread-safe: metrics are touched from the trainer thread AND the DHT
    event loop; one lock guards registry lookup and every metric mutation
    (orders of magnitude cheaper than the RPCs they instrument), and the
    JSONL mirror has its OWN lock so a slow disk never blocks counters.
    """

    MAX_EVENTS = 4096  # in-memory trace bound; the JSONL file is unbounded

    def __init__(
        self,
        peer: str = "",
        event_log_path: Optional[str] = None,
        clock: Optional[Callable[[], float]] = None,
        link_top_k: int = 8,
        max_events: Optional[int] = None,
    ) -> None:
        self.peer = peer
        self.clock = clock or monotonic_clock
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        # ``max_events`` overrides the in-memory bound: consumers that read
        # events from MEMORY instead of the JSONL sink (the swarm simulator
        # dumps post-run) need room for a whole scenario per peer
        self.events: Deque[dict] = deque(maxlen=max_events or self.MAX_EVENTS)
        # per-link network estimator (telemetry/links.py), created on first
        # observation; ``link_top_k`` bounds how many links ride the metrics
        # bus snapshot (the busiest first)
        self.link_top_k = int(link_top_k)
        self._links = None
        self._lock = threading.Lock()
        # the JSONL mirror gets its OWN lock: a slow disk stalling an event
        # write must not block counter updates on the DHT event loop
        self._log_lock = threading.Lock()
        self._log = (
            open(event_log_path, "a", buffering=1, encoding="utf-8")
            if event_log_path
            else None
        )
        self._last_snapshot_at: Optional[float] = None
        self._last_snapshot: Optional[Dict[str, float]] = None

    # ------------------------------------------------------------- metrics

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self.counters.get(name)
            if c is None:
                c = self.counters[name] = Counter(self._lock)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self.gauges.get(name)
            if g is None:
                g = self.gauges[name] = Gauge(self._lock)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(self._lock)
            return h

    # --------------------------------------------------------------- links

    def links(self):
        """This peer's per-link network estimator (telemetry/links.py),
        created on first use. Instrumented sites must only reach it behind a
        ``tele is not None`` check — disabled telemetry never allocates it."""
        if self._links is None:
            from dedloc_tpu_torch.telemetry.links import LinkTable

            self._links = LinkTable()
        return self._links

    # -------------------------------------------------------------- events

    def event(self, name: str, **attrs: Any) -> dict:
        """Record a point event (and mirror it to the JSONL log). When a
        trace context is live (inside a span, or a handler that adopted a
        remote caller's context) the record gains the linkage fields
        ``trace`` and ``parent`` — explicit attrs of the same name win (the
        span exit path passes its own)."""
        record = {"t": get_dht_time(), "peer": self.peer, "event": name}
        for k, v in attrs.items():
            record[k] = _jsonable(v)
        if "trace" not in record:
            tc = _TRACE.get()
            if tc is not None:
                record["trace"] = tc[0]
                record["parent"] = tc[1]
        self.events.append(record)  # deque.append is atomic under the GIL
        if self._log is not None:
            line = json.dumps(record) + "\n"
            with self._log_lock:
                try:
                    if self._log is not None:
                        self._log.write(line)
                except (OSError, ValueError):
                    # a full disk / closed file must never kill training
                    pass
        return record

    @contextmanager
    def span(
        self, name: str, trace_seed: Optional[str] = None, **attrs: Any
    ) -> Iterator[Dict[str, Any]]:
        """Trace a region: yields a mutable attrs dict the caller can
        annotate with the outcome (``ctx["ok"] = True``); on exit the span
        becomes one event carrying ``dur_s`` and feeds the histogram of the
        same name.

        Linkage: every span gets a fresh ``span`` id and records ``trace``
        and (when nested or remotely called) ``parent``. The trace id is the
        innermost live context's; with none live it derives from
        ``trace_seed`` (deterministic — every peer of a round seeds from the
        same round_id, so their spans stitch without a handshake) or is
        freshly random. A remote parent (adopted off the RPC framing) also
        stamps ``caller`` with the calling peer's label. The span is the
        live context for its duration, so nested spans and outbound RPCs
        inherit it."""
        ctx: Dict[str, Any] = dict(attrs)
        span_id = new_span_id()
        ambient = _TRACE.get()
        if ambient is not None:
            trace_id, parent, caller, remote = ambient
        else:
            trace_id = (
                trace_id_for(trace_seed) if trace_seed else new_span_id()
            )
            parent, caller, remote = None, "", False
        linkage: Dict[str, Any] = {"trace": trace_id, "span": span_id}
        if parent is not None:
            linkage["parent"] = parent
        if remote and caller:
            linkage["caller"] = caller
        token = _TRACE.set((trace_id, span_id, self.peer, False))
        start = self.clock()
        try:
            yield ctx
        finally:
            _TRACE.reset(token)
            # clamped at 0: a span that straddles a FakeClock exit sees the
            # clock retreat by the whole fake offset — a huge negative
            # duration would poison the histogram min/mean forever
            dur = max(0.0, self.clock() - start)
            self.histogram(name).observe(dur)
            # dict-merge (not double-splat): a caller annotating a key that
            # collides with the linkage must override, not TypeError
            self.event(name, dur_s=dur, **{**linkage, **ctx})

    # ----------------------------------------------------------- snapshots

    def snapshot(self) -> Dict[str, float]:
        """Flat {name: float} view of every metric — the payload that rides
        the signed DHT metrics bus (LocalMetrics.telemetry). Histograms
        flatten to ``<name>.count`` / ``<name>.mean`` / ``<name>.max``."""
        with self._lock:
            out: Dict[str, float] = {}
            for name, c in self.counters.items():
                out[name] = c.value
            for name, g in self.gauges.items():
                out[name] = g.value
            for name, h in self.histograms.items():
                if h.count:
                    out[f"{name}.count"] = float(h.count)
                    out[f"{name}.mean"] = h.mean
                    out[f"{name}.max"] = h.max
        if self._links is not None:
            # bounded top-K per-link estimates ride the same flat snapshot
            # ("link.<host:port>.rtt_s" etc, telemetry/links.py) — the
            # coordinator folds them into the swarm topology record
            out.update(self._links.flat(self.link_top_k))
        return out

    def maybe_snapshot(self, period: float) -> Dict[str, float]:
        """Snapshot freshly at most once per ``period`` seconds (the
        metrics-bus throttle); between refreshes the PREVIOUS snapshot is
        returned rather than None — each publish OVERWRITES the peer's DHT
        subkey, so a None tail on the latest record would zero the
        coordinator's swarm-health counters for most aggregation ticks. A
        slightly stale tail beats a missing one."""
        now = self.clock()
        if (
            self._last_snapshot is None
            or self._last_snapshot_at is None
            or now - self._last_snapshot_at >= period
            # clock retreated (FakeClock exited): refresh rather than serve
            # the frozen pre-exit snapshot until real time catches up
            or now < self._last_snapshot_at
        ):
            self._last_snapshot_at = now
            self._last_snapshot = self.snapshot()
            if self._links is not None:
                # mirror the refreshed link estimates into the event log on
                # the same throttle (one link.stats event per tracked link)
                # so ``runlog_summary --topology`` works from JSONL alone
                self._links.emit_events(self)
        return self._last_snapshot

    def close(self) -> None:
        if self._links is not None:
            # final link.stats flush: short runs (tests, one-round repros)
            # may never cross a snapshot period
            self._links.emit_events(self)
        with self._log_lock:
            if self._log is not None:
                self._log.close()
                self._log = None


# ---------------------------------------------------------------------------
# Process-global registry (one peer per process in production). Instrumented
# code checks ``registry._active is not None`` directly — one attribute load,
# the same production fast path as testing/faults.py.
# ---------------------------------------------------------------------------

_active: Optional[Telemetry] = None


def install(telemetry: Telemetry) -> Telemetry:
    global _active
    _active = telemetry
    return telemetry


def uninstall(telemetry: Optional[Telemetry] = None) -> None:
    global _active
    if telemetry is None or _active is telemetry:
        _active = None


def active() -> Optional[Telemetry]:
    return _active


def enabled() -> bool:
    return _active is not None


def resolve(local: Optional[Telemetry]) -> Optional[Telemetry]:
    """Component-scoped registry if one was injected, else the process
    global, else None (disabled)."""
    return local if local is not None else _active


# cheap helpers for free functions that have no component scope (frame I/O,
# fault firing); all no-ops while telemetry is disabled
def inc(name: str, n: float = 1.0) -> None:
    if _active is not None:
        _active.counter(name).inc(n)


def event(name: str, **attrs: Any) -> None:
    if _active is not None:
        _active.event(name, **attrs)


@contextmanager
def null_span() -> Iterator[Dict[str, Any]]:
    """Shared no-op span for disabled telemetry (lets call sites keep one
    ``with`` shape)."""
    yield {}


def span(name: str, telemetry: Optional[Telemetry] = None, **attrs: Any):
    tele = resolve(telemetry)
    return tele.span(name, **attrs) if tele is not None else null_span()
