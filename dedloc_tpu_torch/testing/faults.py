"""Deterministic fault injection + fake clock for peer-lifecycle tests.

Multi-peer failure paths (leader death mid-matchmaking, truncated state
downloads, stragglers past SLA, join-during-round) used to be exercised only
by real-time churn harnesses that flake on a loaded host. This module makes
fault behavior a first-class, deterministically-testable mechanism:

- ``FaultSchedule``: a seeded schedule of named fault points. Tests program
  faults (``inject``); instrumented code consults the schedule (``fire``)
  at well-known points and applies the returned action. The schedule logs
  every observation and firing so tests can assert exactly what happened.
- ``FakeClock``: scenario time. All matchmaking windows, straggler SLAs and
  DHT record expirations are deadlines on ``get_dht_time()``, so advancing
  the shared offset (``set_dht_time_offset``) expires them instantly —
  scenarios that used to be wall-clock soaks become reproducible unit tests
  that never idle out a real window.

Fault points currently wired:

| point                  | where                                   | context keys |
|------------------------|-----------------------------------------|--------------|
| ``rpc.client.call``    | ``RPCClient.call`` before the frame     | method, endpoint, client |
| ``rpc.server.dispatch``| ``RPCServer._dispatch`` before handler  | method, peer, server, port |
| ``averager.state_get`` | state-snapshot reply (blob mutation)    | size |
| ``checkpoint.shard_get`` | sharded-checkpoint shard reply (bytes mutation) | index, size |
| ``fleet.preempt``      | ``LocalFleet`` victim selection         | alive |
| ``averager.hier_wan``  | delegate's WAN leg of a hierarchical round | round_id, delegate |
| ``topology.plan_record`` | plan publish/fetch (``averaging/planwire.py``; ``drop`` = record lost in flight, others raise) | op, epoch (publish only) |

Actions: ``drop`` (reset the connection / raise ConnectionResetError —
process-death semantics: a killed peer's OS resets its sockets), ``delay``
(hold the RPC for ``delay`` seconds), ``error`` (raise an OSError),
``truncate`` (cut a state blob to ``fraction`` of its bytes, leaving the
checksum stale), ``kill`` (run ``callback`` — e.g. stop a server — then
reset the connection).

The hooks are zero-cost when no schedule is installed: instrumented code
checks the module-level ``_active`` attribute and returns immediately.
Production never installs a schedule.
"""
from __future__ import annotations

import asyncio
import inspect
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import heapq

from dedloc_tpu_torch.core.timeutils import set_dht_time_offset, set_dht_time_source


@dataclass
class Fault:
    """One programmed fault. ``times`` bounds how often it fires (-1 =
    unlimited); ``match`` filters on the fire-site context dict; ``target``
    names a specific victim (fleet preemption); ``callback`` runs for
    ``kill`` actions (sync or async)."""

    point: str
    action: str  # drop | delay | error | truncate | kill
    times: int = 1
    match: Optional[Callable[[Dict[str, Any]], bool]] = None
    delay: float = 0.0
    fraction: float = 0.5
    target: Optional[str] = None
    callback: Optional[Callable[..., Any]] = None


class FaultSchedule:
    """Seeded schedule of named fault points.

    Usage::

        with FaultSchedule(seed=0) as schedule:
            schedule.inject("rpc.server.dispatch", "drop",
                            match=lambda ctx: ctx["method"] == "mm.join")
            ... run the scenario ...
            assert schedule.fired  # the fault actually triggered

    ``rng`` is the schedule's seeded randomness — harnesses that need a
    random choice (e.g. fleet victim selection) draw from it so the whole
    scenario replays from one seed.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.faults: List[Fault] = []
        # (point, context) logs: every consultation, and every actual firing
        self.observed: List[Tuple[str, Dict[str, Any]]] = []
        self.fired: List[Tuple[str, Dict[str, Any]]] = []

    def inject(
        self,
        point: str,
        action: str,
        *,
        times: int = 1,
        match: Optional[Callable[[Dict[str, Any]], bool]] = None,
        delay: float = 0.0,
        fraction: float = 0.5,
        target: Optional[str] = None,
        callback: Optional[Callable[..., Any]] = None,
    ) -> Fault:
        fault = Fault(point, action, times, match, delay, fraction, target,
                      callback)
        self.faults.append(fault)
        return fault

    def fire(self, point: str, **context: Any) -> Optional[Fault]:
        """Called by instrumented code at a fault point; returns the fault
        to apply (consuming one of its ``times``), or None."""
        self.observed.append((point, context))
        for fault in self.faults:
            if fault.point != point or fault.times == 0:
                continue
            if fault.match is not None and not fault.match(context):
                continue
            if fault.target is not None:
                # a targeted fault only fires when its victim is actually in
                # the offered candidate set — otherwise it stays ARMED (not
                # consumed) so "kill trainer1" still means trainer1 on a
                # later tick, never a silent random victim
                candidates = context.get("alive")
                if candidates is not None and fault.target not in candidates:
                    continue
            if fault.times > 0:
                fault.times -= 1
            self.fired.append((point, context))
            # every injected fault is a trace event (docs/observability.md):
            # the process-global registry gets the schedule-level view; the
            # instrumented site additionally attributes a "fault.applied"
            # event to its own per-peer registry. Import deferred — the
            # production fast path (no schedule installed) never pays it.
            from dedloc_tpu_torch.telemetry import registry as telemetry

            if telemetry._active is not None:
                telemetry._active.counter("faults.injected").inc()
                telemetry._active.event(
                    "fault.injected", point=point, action=fault.action,
                    **{
                        k: v
                        for k, v in context.items()
                        if isinstance(v, (str, int, float, bool, bytes))
                    },
                )
            return fault
        return None

    # ------------------------------------------------------- install/uninstall

    def install(self) -> "FaultSchedule":
        global _active
        _active = self
        return self

    def uninstall(self) -> None:
        global _active
        if _active is self:
            _active = None

    def __enter__(self) -> "FaultSchedule":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


# the installed schedule; instrumented code checks this attribute directly
# (``faults._active is not None``) so the production fast path is one load
_active: Optional[FaultSchedule] = None


def active() -> Optional[FaultSchedule]:
    return _active


def fire(point: str, **context: Any) -> Optional[Fault]:
    """Consult the installed schedule (None when fault injection is off)."""
    return _active.fire(point, **context) if _active is not None else None


async def apply_transport_fault(fault: Fault, what: str) -> None:
    """Apply a client/server transport fault inside the event loop. ``drop``
    and ``kill`` raise (the caller sees a dead peer); ``delay`` returns
    after sleeping; ``error`` raises an OSError."""
    if fault.action == "delay":
        await asyncio.sleep(fault.delay)
        return
    if fault.action == "kill" and fault.callback is not None:
        result = fault.callback()
        if inspect.isawaitable(result):
            await result
    if fault.action in ("drop", "kill"):
        raise ConnectionResetError(f"fault injected: dropped {what}")
    if fault.action == "error":
        raise OSError(f"fault injected: error on {what}")


class ClockHandle:
    """Cancellation handle for a ``FakeClock.wake_at`` sleeper.

    ``cancel`` notifies the owning clock so cancelled sleepers are counted
    (and compacted) EAGERLY instead of lingering until they surface at the
    head of the schedule — a churn wave that cancels thousands of pending
    wakes must not leave the clock walking dead entries for the rest of
    the run."""

    __slots__ = ("cancelled", "_clock")

    def __init__(self, clock: Optional["FakeClock"] = None) -> None:
        self.cancelled = False
        self._clock = clock

    def cancel(self) -> None:
        if not self.cancelled:
            self.cancelled = True
            if self._clock is not None:
                self._clock._note_cancelled()


class FakeClock:
    """Deterministic scenario clock over ``set_dht_time_offset``.

    All DHT expirations, matchmaking windows and straggler deadlines are
    absolute timestamps on ``get_dht_time()``; with a FakeClock installed
    they only expire when the test calls ``advance`` — a loaded host can
    never spuriously time a scenario out, and a test never sleeps real
    time to wait a window out.

    The offset is process-global (every in-process peer shares the DHT
    clock, as NTP-synchronized real peers would), and restored to zero on
    exit.

    **Sleepers and the seeded tie-break.** ``wake_at(when, callback)``
    registers a callback fired by ``advance`` when scenario time reaches
    ``when``. Two sleepers registered for the IDENTICAL fake timestamp used
    to resolve in heap insertion order — an implementation detail of
    ``heapq`` that is not promised across Python versions, so simulator
    runs were not bit-reproducible. The documented ordering rule is now:
    same-deadline sleepers fire in the order of a per-sleeper draw from the
    clock's seeded RNG (``seed`` constructor arg), taken at REGISTRATION
    time. Given the same seed and the same registration sequence, the wake
    order is a pure function of the schedule on every Python version; a
    different seed may legally produce a different (but equally
    deterministic) order. The discrete-event engine
    (``simulator/engine.py``) draws the same stream via
    ``tiebreak_epsilon`` for its event-loop timers, so one seed governs
    every same-timestamp decision in a simulated swarm.

    **Frozen mode.** ``frozen=True`` additionally installs a full
    ``get_dht_time`` override returning exactly ``start + advanced``: real
    seconds spent EXECUTING scenario code between advances no longer leak
    into the timeline (with only an offset they would, because the offset
    rides on ``time.time()``). The simulator engine uses this; offset-only
    behavior is unchanged for existing tests.
    """

    # timer-wheel geometry. Sleeper rows are binned by ABSOLUTE slot index
    # (``int(when / slot_width)``) into sparse dict-of-bucket levels, so
    # there is no modulo wrap to disambiguate: bucket index order IS time
    # order. Level 0 holds the dominant near-term band (sub-second waits),
    # level 1 the next ~65 s, and everything farther rides an overflow
    # heap. Scheduling is O(1); firing sorts one bucket at a time (each
    # row is sorted exactly once, amortized O(log bucket)).
    _L0_SLOT_S = 1e-3
    _L0_SPAN_S = 0.256
    _L1_SLOT_S = 0.256
    _L1_SPAN_S = 65.536

    def __init__(self, start: float = 0.0, seed: int = 0,
                 frozen: bool = False):
        self.offset = float(start)
        self.frozen = bool(frozen)
        self.rng = random.Random(seed)
        # rows: (when, tiebreak, seq, callback, handle) — ``tiebreak`` is
        # the seeded draw that defines same-deadline order; ``seq`` only
        # breaks the astronomically-unlikely equal-draw case. Rows live in
        # the wheel buckets / overflow heap; during an ``advance_to`` drain
        # the due ones move to the ``_due`` heap, which replays them in
        # exact (when, tiebreak, seq) order.
        self._l0: Dict[int, List[tuple]] = {}
        self._l1: Dict[int, List[tuple]] = {}
        self._l0_idx: List[int] = []  # heaps of occupied bucket indices
        self._l1_idx: List[int] = []
        self._overflow: List[tuple] = []
        self._due: List[tuple] = []
        self._drain_target: Optional[float] = None
        self._live = 0  # pending, not cancelled
        self._cancelled_resident = 0  # cancelled but still occupying a row
        # merged next-deadline cursor: the engine polls ``next_wake`` every
        # virtual tick, so the earliest pending deadline is cached and
        # updated incrementally on insert — an idle swarm pays O(1) per
        # tick, not a wheel scan. ``None`` = "no sleepers", ``()`` = stale.
        self._next_wake_cache: Any = None
        self._seq = 0

    # ------------------------------------------------------------- sleepers

    def tiebreak_epsilon(self, scale: float = 1e-6) -> float:
        """A strictly-positive seeded jitter in ``(0, ~2*scale]`` for the
        engine's event-loop timer deadlines. Two components, both
        deterministic functions of the schedule: a seeded draw at ``scale``
        (dominates — same-deadline ordering follows the seeded stream, not
        timer-heap internals) plus a strictly-increasing sequence term
        three orders of magnitude smaller, which keeps two epsilons
        distinct even when their draws round to the same float (at
        simulation-epoch magnitudes a float's resolution is ~1e-10 s, so a
        pure nano-scale draw would quantize to a handful of values and
        collide — reintroducing heap-order nondeterminism)."""
        self._seq += 1
        return (
            (1.0 - self.rng.random()) * scale
            + (self._seq % 1000 + 1) * scale * 1e-3
        )

    def wake_at(self, when: float, callback: Callable[[], Any]) -> ClockHandle:
        """Register ``callback`` to fire when scenario time reaches
        ``when`` (fired inside ``advance``, never from real time)."""
        handle = ClockHandle(self)
        # the seeded draw MUST stay one-per-registration, taken here, in
        # registration order — it is the documented same-deadline tie-break
        # stream, and tests cross-check it against an independent
        # ``random.Random(seed)``
        row = (float(when), self.rng.random(), self._seq, callback, handle)
        self._seq += 1
        self._live += 1
        self._place(row)
        cache = self._next_wake_cache
        if cache is None or (cache != () and row[0] < cache):
            self._next_wake_cache = row[0]
        return handle

    def _place(self, row: tuple) -> None:
        """Bin one row into the wheel level (or overflow heap) its distance
        from now selects; rows due within an in-progress drain go straight
        to the drain's replay heap."""
        when = row[0]
        if self._drain_target is not None and when <= self._drain_target:
            heapq.heappush(self._due, row)
            return
        delta = when - self.offset
        if delta < self._L0_SPAN_S:
            buckets, idx_heap = self._l0, self._l0_idx
            idx = int(when // self._L0_SLOT_S)
        elif delta < self._L1_SPAN_S:
            buckets, idx_heap = self._l1, self._l1_idx
            idx = int(when // self._L1_SLOT_S)
        else:
            heapq.heappush(self._overflow, row)
            return
        bucket = buckets.get(idx)
        if bucket is None:
            buckets[idx] = [row]
            heapq.heappush(idx_heap, idx)
        else:
            bucket.append(row)

    def _note_cancelled(self) -> None:
        """Eager cancellation accounting (called by ``ClockHandle.cancel``):
        move one row from live to cancelled-resident and compact the wheel
        once dead rows outnumber live ones — a mass-cancel churn wave must
        not leave the schedule mostly tombstones."""
        self._live -= 1
        self._cancelled_resident += 1
        self._next_wake_cache = ()  # the cancelled row may have been the min
        if self._cancelled_resident > 64 and \
                self._cancelled_resident > self._live:
            self._compact()

    def _compact(self) -> None:
        rows = [
            row
            for bucket_map in (self._l0, self._l1)
            for bucket in bucket_map.values()
            for row in bucket
            if not row[4].cancelled
        ]
        rows += [row for row in self._overflow if not row[4].cancelled]
        due = [row for row in self._due if not row[4].cancelled]
        self._l0.clear()
        self._l1.clear()
        self._l0_idx.clear()
        self._l1_idx.clear()
        self._overflow.clear()
        self._due.clear()
        if due:
            self._due = due
            heapq.heapify(self._due)
        self._cancelled_resident = 0
        for row in rows:
            self._place(row)

    def _level_min(self, buckets: Dict[int, List[tuple]],
                   idx_heap: List[int]) -> Optional[float]:
        """Earliest live deadline in one wheel level: the lowest-indexed
        bucket's min (bucket index order is time order). Cancelled rows
        encountered on the way are dropped for good."""
        while idx_heap:
            idx = idx_heap[0]
            bucket = buckets.get(idx)
            if not bucket:
                heapq.heappop(idx_heap)
                buckets.pop(idx, None)
                continue
            best = None
            live = []
            for row in bucket:
                if row[4].cancelled:
                    self._cancelled_resident -= 1
                    continue
                live.append(row)
                if best is None or row[0] < best:
                    best = row[0]
            if not live:
                heapq.heappop(idx_heap)
                buckets.pop(idx, None)
                continue
            if len(live) != len(bucket):
                buckets[idx] = live
            return best
        return None

    def next_wake(self) -> Optional[float]:
        """Earliest pending sleeper deadline, or None (cached between
        schedule mutations — the engine's merged-cursor read)."""
        cache = self._next_wake_cache
        if cache != ():
            return cache
        best = self._level_min(self._l0, self._l0_idx)
        l1_best = self._level_min(self._l1, self._l1_idx)
        if l1_best is not None and (best is None or l1_best < best):
            best = l1_best
        overflow = self._overflow
        while overflow and overflow[0][4].cancelled:
            heapq.heappop(overflow)
            self._cancelled_resident -= 1
        if overflow and (best is None or overflow[0][0] < best):
            best = overflow[0][0]
        self._next_wake_cache = best
        return best

    def _pull_due(self, target: float) -> None:
        """Move every row with ``when <= target`` from the wheel levels and
        the overflow heap onto the ``_due`` replay heap."""
        due = self._due
        for buckets, idx_heap, slot_s in (
            (self._l0, self._l0_idx, self._L0_SLOT_S),
            (self._l1, self._l1_idx, self._L1_SLOT_S),
        ):
            # compare in INDEX space with the same floor division used by
            # ``_place``: float division is monotone, so ``when <= target``
            # always implies ``row_idx <= target_idx`` and a row can never
            # be stranded in a bucket the pull considers "later"
            target_idx = int(target // slot_s)
            while idx_heap:
                idx = idx_heap[0]
                bucket = buckets.get(idx)
                if not bucket:
                    heapq.heappop(idx_heap)
                    buckets.pop(idx, None)
                    continue
                if idx > target_idx:
                    break  # every later bucket is strictly later still
                if idx < target_idx:  # bucket entirely due
                    heapq.heappop(idx_heap)
                    buckets.pop(idx, None)
                    for row in bucket:
                        heapq.heappush(due, row)
                    continue
                keep = [row for row in bucket if row[0] > target]
                for row in bucket:
                    if row[0] <= target:
                        heapq.heappush(due, row)
                if keep:
                    buckets[idx] = keep
                else:
                    heapq.heappop(idx_heap)
                    buckets.pop(idx, None)
                break  # rows past this partially-due bucket are all later
        overflow = self._overflow
        while overflow and overflow[0][0] <= target:
            heapq.heappush(due, heapq.heappop(overflow))

    def _fire_due(self) -> None:
        """Fire every sleeper already due at the current offset."""
        self.advance_to(self.offset)

    def sleeper_stats(self) -> Dict[str, int]:
        """Schedule occupancy, for diagnostics and regression tests:
        ``live`` pending sleepers, ``resident`` rows actually held (live +
        cancelled tombstones awaiting compaction)."""
        resident = (
            sum(len(b) for b in self._l0.values())
            + sum(len(b) for b in self._l1.values())
            + len(self._overflow)
            + len(self._due)
        )
        return {
            "live": self._live,
            "resident": resident,
            "cancelled_resident": self._cancelled_resident,
            # lifetime registrations (wake_at rows + tie-break draws): the
            # bench's "timer events scheduled" numerator — deterministic for
            # a given seed+scenario, so events/sec isolates wall-time cost
            "scheduled_total": self._seq,
        }

    # ------------------------------------------------------------ lifecycle

    def now(self) -> float:
        return self.offset

    def __enter__(self) -> "FakeClock":
        set_dht_time_offset(self.offset)
        if self.frozen:
            set_dht_time_source(self.now)
        return self

    def advance(self, seconds: float) -> None:
        self.advance_to(self.offset + float(seconds))

    def advance_to(self, target: float) -> None:
        """Move scenario time forward to ``target``, firing due sleepers in
        deadline order (seeded tie-break within one deadline); each sleeper
        observes the clock AT its own deadline."""
        target = float(target)
        if self._live:
            previous_target = self._drain_target
            self._drain_target = target
            self._pull_due(target)
            due = self._due
            consumed = bool(due)
            while due:
                row = heapq.heappop(due)
                if row[4].cancelled:
                    self._cancelled_resident -= 1
                    continue
                self._live -= 1
                when = row[0]
                if when > self.offset:
                    self.offset = when
                    set_dht_time_offset(when)
                row[3]()  # may register new due sleepers: _place routes
                # anything <= target straight onto this replay heap
            self._drain_target = previous_target
            if consumed:
                self._next_wake_cache = ()
        if target > self.offset:
            self.offset = target
        set_dht_time_offset(self.offset)

    def __exit__(self, *exc) -> None:
        set_dht_time_offset(0.0)
        if self.frozen:
            set_dht_time_source(None)
