"""Time, expiration and throughput-EMA utilities.

Capability parity with the reference's use of ``hivemind.get_dht_time()``
(DHT-synchronized wall clock) and ``performance_ema.samples_per_second``
(reference: albert/run_trainer.py:145, albert/arguments.py:48-50).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Generic, Optional, TypeVar

DHTExpiration = float  # absolute unix timestamp after which a record is dead
MAX_DHT_TIME_DISCREPANCY = 3.0

_dht_time_offset = 0.0
# optional full override of the clock (None = wall clock + offset). The
# discrete-event simulator installs one so scenario time is EXACTLY the
# engine's virtual time: with only an offset, real seconds spent executing
# Python between fake-clock advances would leak into get_dht_time() and make
# two same-seed runs diverge wherever a deadline comparison is close.
_dht_time_source = None


def get_dht_time() -> DHTExpiration:
    """Wall-clock time shared across the collaboration.

    Peers are assumed NTP-synchronized (same assumption as the reference
    stack); ``set_dht_time_offset`` exists for tests that need a fake clock,
    and ``set_dht_time_source`` for the simulator's fully-virtual clock.
    """
    if _dht_time_source is not None:
        return _dht_time_source()
    return time.time() + _dht_time_offset


def set_dht_time_offset(offset: float) -> None:
    global _dht_time_offset
    _dht_time_offset = offset


def set_dht_time_source(source) -> None:
    """Install (or with None, remove) a zero-argument callable that REPLACES
    the wall clock entirely. Scenario code under the simulator engine sees a
    bit-reproducible timeline regardless of how long the host takes to
    execute it."""
    global _dht_time_source
    _dht_time_source = source


def monotonic() -> float:
    """Monotonic duration/deadline clock for simulator-reachable code.

    Production (no fake source, offset 0) is plain ``time.monotonic()``.
    Under ``FakeClock`` the offset advances it exactly with scenario time;
    under the discrete-event simulator the installed source replaces it
    entirely, so deadlines computed from it expire on the VIRTUAL timeline
    instead of counting real host-execution seconds. This is the approved
    clock the dedlint ``clock-monotonic`` rule points at — raw
    ``time.monotonic()``/``time.perf_counter()`` in sim-reachable modules
    is blind to both mechanisms (docs/contributor.md).

    Like ``get_dht_time()``, the value is DISCONTINUOUS across a frozen-
    source install/uninstall (`set_dht_time_source`): a timestamp taken on
    one side compared on the other yields nonsense ages. The standing
    contract (same one every FakeClock/simulator consumer already lives
    by) is that objects are created and driven on the SAME side — the sim
    engine spawns its peers inside the engine context, and FakeClock test
    scenarios construct their components inside the clock's scope."""
    if _dht_time_source is not None:
        return _dht_time_source()
    return time.monotonic() + _dht_time_offset


T = TypeVar("T")


@dataclass
class ValueWithExpiration(Generic[T]):
    value: T
    expiration_time: DHTExpiration

    def expired(self, now: Optional[DHTExpiration] = None) -> bool:
        return (now if now is not None else get_dht_time()) > self.expiration_time

    def __iter__(self):
        return iter((self.value, self.expiration_time))


class PerformanceEMA:
    """Exponential moving average of samples-per-second throughput.

    Matches the semantics consumed by the reference trainers via
    ``collaborative_optimizer.performance_ema.samples_per_second``
    (albert/run_trainer.py:145): updated once per local accumulation step with
    the number of samples processed; pausable while the peer is inside an
    averaging round so network time does not pollute compute throughput.
    """

    def __init__(self, alpha: float = 0.1, eps: float = 1e-20):
        self.alpha = alpha
        self.eps = eps
        self.ema_seconds_per_sample = 0.0
        self.samples_per_second = eps
        self.timestamp = time.perf_counter()
        self.paused = False
        self.num_updates = 0

    def update(self, num_processed: int) -> float:
        assert num_processed > 0, "must process at least one sample"
        now = time.perf_counter()
        elapsed = max(now - self.timestamp, 1e-9)
        self.timestamp = now
        if self.paused:
            return self.samples_per_second
        seconds_per_sample = elapsed / num_processed
        if self.num_updates == 0:
            self.ema_seconds_per_sample = seconds_per_sample
        else:
            self.ema_seconds_per_sample = (
                self.alpha * seconds_per_sample
                + (1 - self.alpha) * self.ema_seconds_per_sample
            )
        self.num_updates += 1
        self.samples_per_second = 1.0 / max(self.ema_seconds_per_sample, self.eps)
        return self.samples_per_second

    def pause(self) -> None:
        """Stop counting elapsed time (e.g. during an averaging round)."""
        self.paused = True

    def resume(self) -> None:
        self.paused = False
        self.timestamp = time.perf_counter()

    def __repr__(self):
        return f"PerformanceEMA({self.samples_per_second:.3f} samples/s)"


@dataclass
class TimedStorageEntry(Generic[T]):
    value: T
    expiration_time: DHTExpiration = field(default=0.0)
