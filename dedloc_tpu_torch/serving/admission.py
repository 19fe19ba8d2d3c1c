"""Per-peer rate admission: token buckets keyed by sender identity.

ROADMAP item 3's remainder: ``core/auth.py`` gates WHO may join a run, but
nothing bounded HOW FAST an authorized (or open-swarm) peer may hit the
write paths. One ``Admission`` instance fronts both rate-controlled RPC
surfaces — the DHT ``dht.store`` handler and the serving plane's
``expert.dispatch`` handler — refusing over-rate requests with a NAMED
reason the caller can distinguish from a dead peer (a refusal must steer
the router to another replica, not trigger a retry storm at the same one).

Clocks ride ``timeutils.monotonic`` so refill happens on the virtual
timeline under the simulator (dedlint clock discipline)."""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

from dedloc_tpu_torch.core import timeutils

# refusal reasons (the named contract: serve.reject events carry one)
REASON_OVER_RATE = "over-rate"
REASON_OVER_CAPACITY = "over-capacity"
REASON_WRONG_VERSION = "wrong-version"
REASON_UNKNOWN_EXPERT = "unknown-expert"


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill toward ``burst``.

    Lazy refill against the injected clock — no background task, safe in
    virtual time."""

    def __init__(
        self,
        rate: float,
        burst: float,
        clock: Callable[[], float] = timeutils.monotonic,
    ):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = float(clock())

    def _refill(self, now: float) -> None:
        dt = max(0.0, now - self._t)
        if dt > 0:
            self._tokens = min(self.burst, self._tokens + dt * self.rate)
            self._t = now

    def allow(self, n: float = 1.0) -> bool:
        self._refill(float(self._clock()))
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def available(self) -> float:
        self._refill(float(self._clock()))
        return self._tokens


class Admission:
    """Per-identity token buckets with a bounded table.

    ``check(identity)`` returns ``None`` to admit or a named reason to
    refuse. Identities are whatever the transport can attribute — the
    sender's node-id hex on DHT RPCs, the caller label on dispatch RPCs,
    falling back to the source host. The table is LRU-bounded so a sybil
    flood of fresh identities cannot grow it without bound (each eviction
    hands the evicted identity a FULL bucket again, which is acceptable:
    the flood itself is rate-limited per identity, and the table bound
    caps total admitted rate at ``max_peers * rate``)."""

    def __init__(
        self,
        rate: float = 50.0,
        burst: float = 100.0,
        clock: Callable[[], float] = timeutils.monotonic,
        max_peers: int = 4096,
    ):
        self.rate = float(rate)
        self.burst = float(burst)
        self.max_peers = int(max_peers)
        self._clock = clock
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()

    def check(self, identity: str, cost: float = 1.0) -> Optional[str]:
        identity = str(identity)
        bucket = self._buckets.get(identity)
        if bucket is None:
            bucket = TokenBucket(self.rate, self.burst, clock=self._clock)
            self._buckets[identity] = bucket
            while len(self._buckets) > self.max_peers:
                self._buckets.popitem(last=False)
        else:
            self._buckets.move_to_end(identity)
        if not bucket.allow(cost):
            return REASON_OVER_RATE
        return None
