"""The discrete-event engine: a virtual-time asyncio event loop.

The whole point of the simulator is that the code above the transport seam —
``dht/node.py`` lookups, ``averaging/matchmaking.py`` windows,
``checkpointing/fetcher.py`` backoff ladders — runs UNMODIFIED. All of that
code waits with ``asyncio.sleep`` / ``wait_for`` and reads deadlines off
``get_dht_time()``, so the engine virtualizes exactly those two clocks:

- ``SimLoop`` subclasses the stock selector event loop but reports
  ``time()`` from a frozen, seeded ``FakeClock``. Whenever the loop would
  BLOCK in ``select(timeout)`` waiting for the next timer, the wrapped
  selector instead polls ready I/O (there is none in a pure simulation —
  the simulated transport is queue-based) and JUMPS the clock forward by
  ``timeout``. A scenario that spans hours of straggler windows and DHT
  expirations executes in however long its Python takes, with zero real
  sleeping.
- Every timer deadline gets a strictly-positive seeded epsilon
  (``FakeClock.tiebreak_epsilon``) so no two timers are ever exactly equal:
  same-timestamp ordering is a pure function of the clock seed, not of
  timer-heap internals that vary across Python versions. One seed therefore
  reproduces one global event order, bit for bit.
- ``get_dht_time()`` is overridden at the source (``FakeClock(frozen=True)``)
  so real seconds spent executing scenario Python never leak into the
  simulated timeline.
- ``run_in_executor`` executes inline: a worker thread finishing "whenever
  the OS scheduler felt like it" is exactly the nondeterminism the engine
  exists to remove.

Determinism contract: same engine seed + same scenario code => identical
event sequence, including every telemetry event each simulated peer logs
(modulo wall-clock ``t`` stamps and random span ids; within one process —
dict/set iteration order also depends on the interpreter's hash seed).
"""
from __future__ import annotations

import asyncio
import contextlib
import heapq
import selectors
from typing import Any, Awaitable, Optional

from dedloc_tpu_torch.testing.faults import FakeClock
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# virtual absolute epoch: scenario timestamps must be absolute (records
# compare expirations) but must not depend on when the host runs the
# scenario, or two same-seed runs would diverge. Deliberately SMALL: at a
# unix-scale epoch (1.6e9) a float's resolution is ~2.4e-7 s, swallowing
# the engine's sub-microsecond timer tie-breaks; at 1e6 it is ~1.2e-10 s.
SIM_EPOCH = 1_000_000.0

# a pure simulation that selects with nothing ready, nothing scheduled and
# no main-future callback pending is deadlocked — fail loudly instead of
# spinning forever (real harm: a wedged CI box with zero diagnostics)
_IDLE_POLLS_BEFORE_DEADLOCK = 400
_IDLE_POLL_REAL_S = 0.005

# real-readiness polling cadence: in a pure simulation the only registered
# fd is the loop's self-pipe, whose sole job is waking a BLOCKED select —
# and this selector never blocks. ``call_soon_threadsafe`` appends its
# handle to ``_ready`` regardless, so skipping the poll can never lose a
# callback; the pipe is drained every Nth tick (and on every idle tick) so
# its buffer stays bounded. One real ``select(0)`` per event was ~15% of a
# large scenario's wall time.
_REAL_POLL_EVERY = 64

# same-instant timer batching: every ``call_at`` deadline carries a seeded
# tie-break epsilon in (0, ~2.002e-6] (FakeClock.tiebreak_epsilon at the
# default 1e-6 scale), so timers for one MODELED instant are spread over a
# ~2 µs band and, at asyncio's default nanosecond clock resolution, each
# cost a full loop iteration. Widening the loop's ``_clock_resolution`` to
# cover the whole band pops the batch in ONE iteration — still in heap
# (= seeded tie-break) order. Safe because distinct modeled instants are
# always >= _STREAM_STEP_S (1e-5 s) apart at the network layer and >= ms
# in scenario code, both far above this window.
_BATCH_RESOLUTION_S = 2.5e-6


class _JumpingSelector:
    """Selector proxy: polls real readiness (the loop's self-pipe, mostly)
    and converts every would-be blocking wait into a clock jump."""

    def __init__(self, inner: selectors.BaseSelector, loop: "SimLoop"):
        self._inner = inner
        self._loop = loop
        self._idle_polls = 0
        self._ticks_since_real_poll = 0

    def select(self, timeout: Optional[float] = None):
        # throttled real poll (see _REAL_POLL_EVERY): a simulation tick
        # normally skips the syscall entirely. Any extra registered fd
        # (beyond the loop's own self-pipe) disables the throttle — real
        # I/O readiness must not be deferred by up to N virtual events.
        self._ticks_since_real_poll += 1
        if (
            self._ticks_since_real_poll >= _REAL_POLL_EVERY
            or len(self._inner.get_map()) > 1
        ):
            self._ticks_since_real_poll = 0
            events = self._inner.select(0)
            if events:
                self._idle_polls = 0
                return events
        if timeout is not None and timeout > 0:
            # nothing ready, next loop timer is ``timeout`` virtual seconds
            # out: this is the discrete-event jump. Land EXACTLY on the
            # earlier of the next timer deadline and the next FakeClock
            # ``wake_at`` sleeper — jumping by the float difference instead
            # can fall short by one ulp and spin the loop (offset + tiny ==
            # offset near large offsets), and overjumping a sleeper would
            # run its continuations at the wrong virtual time.
            self._idle_polls = 0
            loop = self._loop
            target = loop.time() + timeout
            sched = loop._scheduled
            if sched and sched[0]._when <= target + 1e-6:
                target = max(loop.time(), sched[0]._when)
            wake = loop.clock.next_wake()
            if wake is not None and wake < target:
                target = max(loop.time(), wake)
            loop.clock.advance_to(target)
            return []
        if timeout is None:
            # no ready callbacks AND no loop timers. A pending FakeClock
            # sleeper can still drive the simulation forward (its callback
            # may resolve whatever the scenario awaits); otherwise only
            # cross-thread wakeups could unblock us — poll briefly
            # (executors are inlined, but a user's thread may still
            # call_soon_threadsafe), and treat a long silence as a
            # simulation deadlock.
            wake = self._loop.clock.next_wake()
            if wake is not None:
                self._idle_polls = 0
                self._loop.clock.advance_to(max(self._loop.time(), wake))
                return []
            self._idle_polls += 1
            if self._idle_polls >= _IDLE_POLLS_BEFORE_DEADLOCK:
                raise RuntimeError(self._deadlock_message())
            self._ticks_since_real_poll = 0
            return self._inner.select(_IDLE_POLL_REAL_S)
        return []

    def _deadlock_message(self) -> str:
        """A deadlock report a wedged 10k-peer CI run is debuggable from:
        how many sleepers are pending-but-unreachable (nothing left that
        could ever advance the clock to them), and which stalled task is
        the oldest (lowest creation sequence — usually the one everybody
        else transitively awaits)."""
        loop = self._loop
        stats = loop.clock.sleeper_stats()
        tasks = [t for t in asyncio.all_tasks(loop) if not t.done()]

        def _task_age(task: "asyncio.Task") -> tuple:
            name = task.get_name()
            digits = name.rsplit("-", 1)[-1]
            return (0, int(digits)) if digits.isdigit() else (1, 0)

        oldest = min(tasks, key=_task_age) if tasks else None
        oldest_desc = "none"
        if oldest is not None:
            coro = oldest.get_coro()
            coro_name = getattr(coro, "__qualname__", repr(coro))
            oldest_desc = f"{oldest.get_name()!r} ({coro_name})"
        return (
            "simulation deadlocked: no ready callbacks, no timers, and "
            "nothing external to wait for "
            f"(unreachable sleepers: {stats['live']} live + "
            f"{stats['cancelled_resident']} cancelled-resident; "
            f"stalled tasks: {len(tasks)}, oldest: {oldest_desc})"
        )

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


class SimLoop(asyncio.SelectorEventLoop):
    """Virtual-time event loop over a frozen seeded FakeClock."""

    def __init__(self, clock: FakeClock):
        super().__init__()
        self.clock = clock
        self._selector = _JumpingSelector(self._selector, self)
        # batch the per-instant epsilon spread into one loop iteration
        # (see _BATCH_RESOLUTION_S): heap order within the batch is the
        # seeded tie-break order, so determinism is unchanged
        self._clock_resolution = _BATCH_RESOLUTION_S

    def time(self) -> float:
        return self.clock.offset

    def call_at(self, when, callback, *args, context=None):
        # the seeded tie-break (see FakeClock.tiebreak_epsilon): distinct
        # deadlines make same-timestamp ordering a function of the seed,
        # and the microsecond-scale magnitude can never move a deadline
        # across any boundary a scenario models (latencies are >= ms).
        # Inlined TimerHandle construction (the non-debug body of
        # BaseEventLoop.call_at): this is the hottest call site of a large
        # scenario — several hundred thousand timers — and the base-class
        # wrapper's debug/closed checks measurably add up.
        timer = asyncio.TimerHandle(
            when + self.clock.tiebreak_epsilon(), callback, args, self,
            context,
        )
        heapq.heappush(self._scheduled, timer)
        timer._scheduled = True
        return timer

    def run_in_executor(self, executor, func, *args):
        # inline for determinism: thread completion order is real-time
        fut = self.create_future()
        try:
            fut.set_result(func(*args))
        except Exception as e:  # noqa: BLE001 — mirror executor semantics
            fut.set_exception(e)
        return fut


class SimEngine:
    """Owns the virtual loop + clock and runs scenario coroutines.

    Usage::

        engine = SimEngine(seed=0)
        result = engine.run(scenario())   # drives to completion, no sleeps
        engine.close()

    or as a context manager. ``engine.clock`` is the shared FakeClock
    (frozen: ``get_dht_time()`` IS virtual time while the engine runs).
    """

    def __init__(self, seed: int = 0, start: float = SIM_EPOCH):
        self.seed = int(seed)
        self.clock = FakeClock(start=start, seed=seed, frozen=True)
        self.loop = SimLoop(self.clock)
        self._entered = False

    # ------------------------------------------------------------ lifecycle

    def __enter__(self) -> "SimEngine":
        self.clock.__enter__()
        self._entered = True
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, coro: Awaitable[Any], timeout: Optional[float] = None) -> Any:
        """Drive ``coro`` to completion at fake-clock speed. ``timeout`` is
        VIRTUAL seconds (a scenario guard, not a wall limit)."""
        # (re-)install THIS engine's clock every run — like the event loop,
        # the dht-time source is process-global, and another engine created
        # or closed in between (the sim_swarm fixture keeps several) would
        # otherwise leave its clock (or the wall clock) installed
        self.clock.__enter__()
        self._entered = True
        asyncio.set_event_loop(self.loop)
        if timeout is not None:
            coro = asyncio.wait_for(coro, timeout=timeout)
        try:
            return self.loop.run_until_complete(coro)
        finally:
            asyncio.set_event_loop(None)

    def close(self) -> None:
        # drain BEFORE restoring the wall clock: cancelling stragglers
        # (maintenance loops, parked reads) still ticks the virtual loop,
        # and every tick re-installs the fake offset process-globally — a
        # drain after clock.__exit__ would leave it installed forever
        if not self.loop.is_closed():
            pending = asyncio.all_tasks(self.loop)
            for task in pending:
                task.cancel()
            if pending:
                with contextlib.suppress(Exception):
                    self.loop.run_until_complete(
                        asyncio.gather(*pending, return_exceptions=True)
                    )
            self.loop.close()
        if self._entered:
            self.clock.__exit__()
            self._entered = False
