"""Per-link network telemetry: RTT + goodput estimates for every (src, dst)
pair this peer talks to.

DeDLOC's averaging strategy adapts to per-peer bandwidth and reliability
(PAPER.md §0), and the hierarchical-topology work (ROADMAP item 1) needs to
learn cliques from *link*-level latency — data the per-peer counters cannot
provide: ``net.bytes_out`` says how much this peer sent, not over which link
or how fast that link ran. This module derives directed per-link estimates
from traffic the peer already generates:

- **RTT**: the TCP connect handshake on every pooled RPC connection is a
  free SYN/SYN-ACK round trip — ``RPCClient._connect`` times it (the "cheap
  piggybacked ping on connection setup"; no new traffic on the hot path).
- **Goodput + chunk latency**: the pipelined all-reduce times every chunk it
  scatters/gathers per destination (``averaging/allreduce.py``), and the
  sharded checkpoint fetcher times every shard per provider
  (``checkpointing/fetcher.py``). Each observation is wire payload bytes
  over wall seconds.

Estimates are EWMAs (recent behavior wins — a link that degraded an hour
into the run must show it) plus a bounded recent-latency window for
percentiles. The table is bounded (``max_links``) and its snapshot is
top-K by traffic, so a thousand-peer swarm cannot bloat a peer's signed
metrics-bus record.

Publication paths, both bounded and both ``_active``-gated:

- ``Telemetry.snapshot()`` folds ``flat(top_k)`` — keys like
  ``link.<host:port>.rtt_s`` / ``.goodput_bps`` — into the flat snapshot
  that rides the signed DHT metrics bus; the coordinator folds those into
  the swarm topology record (``telemetry/health.py``).
- ``emit_events`` mirrors one ``link.stats`` event per tracked link into
  the per-peer JSONL event log (on the snapshot throttle and at close), so
  ``tools/runlog_summary.py --topology`` renders a link matrix from event
  logs alone.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

# EWMA weight of the newest sample. 0.25 ≈ the last ~8 samples dominate:
# reactive enough to catch a link that degrades mid-run, smooth enough that
# one GC pause or retransmit burst does not rewrite the topology
DEFAULT_ALPHA = 0.25


def endpoint_key(endpoint) -> str:
    """Canonical string key for a link destination: ``"host:port"``. Accepts
    (host, port) tuples/lists or a preformatted string."""
    if isinstance(endpoint, str):
        return endpoint
    try:
        host, port = endpoint[0], endpoint[1]
        return f"{host}:{int(port)}"
    except (TypeError, IndexError, ValueError):
        return str(endpoint)


class LinkStats:
    """One directed link (this peer → ``dst``)."""

    WINDOW = 64

    __slots__ = (
        "dst", "rtt_s", "rtt_samples", "rtt_jitter_s", "rtt_min_s",
        "goodput_bps", "bytes", "transfers", "_recent_s", "_recent_bps",
        "last_seq",
    )

    def __init__(self, dst: str) -> None:
        self.dst = dst
        self.rtt_s: Optional[float] = None
        self.rtt_samples = 0
        # EWMA of |sample - estimate|: the link's delay variation, the
        # jitter the simulator's LinkSpec.jitter_s models (a digital twin
        # fitted from this table needs spread, not just the center)
        self.rtt_jitter_s = 0.0
        # fastest sample ever: connect timings ride the caller's event
        # loop, so every sample carries scheduling noise ON TOP of the
        # wire round trip — the minimum is the cleanest base-RTT estimate
        # (the one a fitted simulator model should pay per hop)
        self.rtt_min_s: Optional[float] = None
        self.goodput_bps: Optional[float] = None
        self.bytes = 0
        self.transfers = 0
        self._recent_s: Deque[float] = deque(maxlen=self.WINDOW)
        # recent per-transfer rates: ``peak_bps`` (the best of them) is the
        # least-CONTENDED observation — transfers time wall while the
        # sender's uplink is shared, so the EWMA reads effective goodput
        # under load, while the peak approaches raw link bandwidth. A
        # fitted simulator model must use the peak: it re-simulates the
        # contention itself, and seeding it with contended goodput would
        # charge the queueing twice.
        self._recent_bps: Deque[float] = deque(maxlen=self.WINDOW)
        # observation sequence number (table-wide): eviction order when the
        # table is full — the STALEST link yields, never the newest
        self.last_seq = 0

    def chunk_percentile(self, p: float) -> float:
        if not self._recent_s:
            return 0.0
        s = sorted(self._recent_s)
        return s[min(len(s) - 1, int(p * len(s)))]

    def record(self) -> Dict[str, float]:
        """This link's estimate as one flat dict (the ``link.stats`` event
        payload and the --topology row)."""
        out: Dict[str, float] = {
            "dst": self.dst,
            "bytes": float(self.bytes),
            "transfers": float(self.transfers),
        }
        if self.rtt_s is not None:
            out["rtt_s"] = round(self.rtt_s, 6)
            if self.rtt_min_s is not None:
                out["rtt_min_s"] = round(self.rtt_min_s, 6)
            if self.rtt_samples >= 2:
                out["rtt_jitter_s"] = round(self.rtt_jitter_s, 6)
        if self.goodput_bps is not None:
            out["goodput_bps"] = round(self.goodput_bps, 1)
        if self._recent_bps:
            out["peak_bps"] = round(max(self._recent_bps), 1)
        if self._recent_s:
            out["chunk_p50_s"] = round(self.chunk_percentile(0.50), 6)
            out["chunk_max_s"] = round(max(self._recent_s), 6)
        return out


class LinkTable:
    """Bounded registry of per-destination link estimates. Thread-safe: the
    DHT loop (allreduce, restores) and the trainer thread (snapshots) both
    touch it."""

    def __init__(
        self, alpha: float = DEFAULT_ALPHA, max_links: int = 64
    ) -> None:
        self.alpha = float(alpha)
        self.max_links = int(max_links)
        self._links: Dict[str, LinkStats] = {}
        self._seq = 0  # observation counter: staleness order for eviction
        self._lock = threading.Lock()

    def _link(self, dst) -> LinkStats:
        """The stats record for ``dst``, touching its staleness marker. The
        table stays bounded by EVICTING the least-recently-observed link
        when full: on a churning swarm the links a peer currently talks
        over stay tracked, and estimates for departed peers age out instead
        of squatting the table forever."""
        key = endpoint_key(dst)
        self._seq += 1
        link = self._links.get(key)
        if link is None:
            if len(self._links) >= self.max_links:
                stalest = min(
                    self._links.values(), key=lambda l: l.last_seq
                )
                del self._links[stalest.dst]
            link = self._links[key] = LinkStats(key)
        link.last_seq = self._seq
        return link

    def observe_rtt(self, dst, rtt_s: float) -> None:
        if rtt_s < 0:
            return
        with self._lock:
            link = self._link(dst)
            if link.rtt_s is None:
                link.rtt_s = float(rtt_s)
            else:
                # deviation against the PRE-update estimate: the first
                # sample contributes zero jitter by construction
                link.rtt_jitter_s += self.alpha * (
                    abs(float(rtt_s) - link.rtt_s) - link.rtt_jitter_s
                )
                link.rtt_s += self.alpha * (float(rtt_s) - link.rtt_s)
            link.rtt_min_s = (
                float(rtt_s) if link.rtt_min_s is None
                else min(link.rtt_min_s, float(rtt_s))
            )
            link.rtt_samples += 1

    def observe_transfer(self, dst, nbytes: int, seconds: float) -> None:
        """One wire transfer (chunk, shard, blob) to/from ``dst``:
        ``nbytes`` payload bytes over ``seconds`` wall. Degenerate timings
        (clock granularity, loopback) are clamped, not dropped — a 0-second
        transfer is evidence of a FAST link."""
        if nbytes <= 0:
            return
        seconds = max(float(seconds), 1e-6)
        sample_bps = nbytes / seconds
        with self._lock:
            link = self._link(dst)
            if link.goodput_bps is None:
                link.goodput_bps = sample_bps
            else:
                link.goodput_bps += self.alpha * (
                    sample_bps - link.goodput_bps
                )
            link.bytes += int(nbytes)
            link.transfers += 1
            link._recent_s.append(seconds)
            link._recent_bps.append(sample_bps)

    # ---------------------------------------------------------- publication

    def top(self, k: Optional[int] = None) -> List[LinkStats]:
        """Tracked links, busiest (most bytes, then most RTT samples)
        first, truncated to ``k``."""
        with self._lock:
            links = sorted(
                self._links.values(),
                key=lambda l: (-l.bytes, -l.rtt_samples, l.dst),
            )
        return links if k is None else links[: max(0, k)]

    def flat(self, top_k: int = 8) -> Dict[str, float]:
        """Flat ``{"link.<dst>.<field>": value}`` view of the top-K links —
        the shape that rides the metrics-bus telemetry snapshot (every value
        a float; ``dst`` strings live in the key)."""
        # dedlint: emits=link.* — these snapshot keys are built by hand
        # below, not through a registry call, so the telemetry catalog
        # learns the family from this declaration
        out: Dict[str, float] = {}
        for link in self.top(top_k):
            rec = link.record()
            rec.pop("dst", None)
            for field, value in rec.items():
                out[f"link.{link.dst}.{field}"] = float(value)
        return out

    def records(self, top_k: Optional[int] = None) -> List[Dict[str, float]]:
        return [link.record() for link in self.top(top_k)]

    def emit_events(self, telemetry) -> None:
        """Mirror the current estimates into ``telemetry``'s event log: one
        ``link.stats`` event per tracked link (bounded by the registry's
        ``link_top_k``)."""
        for rec in self.records(getattr(telemetry, "link_top_k", 8)):
            telemetry.event("link.stats", **rec)
