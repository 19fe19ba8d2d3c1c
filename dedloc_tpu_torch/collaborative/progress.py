"""Global progress tracking over the DHT.

Capability parity with hivemind CollaborativeOptimizer's collaboration-state
machinery (SURVEY.md §2.6): every peer publishes its local accumulation
progress under ``{prefix}_progress``; the tracker aggregates to a global
sample count, the current global optimizer step, peer counts and an ETA to
the next step; the refresh period adapts between ``min_refresh_period`` and
``max_refresh_period`` based on that ETA (albert/arguments.py:29-41).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from dataclasses import dataclass
from typing import Optional

from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.dht.dht import DHT
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class LocalProgress:
    step: int
    samples_accumulated: int
    samples_per_second: float
    time: float
    client_mode: bool = False
    # auxiliary peers (run_aux.py capability) publish PRESENCE records:
    # they carry no training progress (zero samples, zero throughput) but
    # let group sizing count the aux as an expected averaging participant —
    # otherwise a leader using the tracker's peer count assembles the
    # instant the last TRAINER joins and the aux systematically loses the
    # race it is there to win
    aux: bool = False
    # most recent training loss this peer advertises (None = not reported):
    # the trunk-health gate compares a peer's own loss against the swarm
    # median to decide whether its gradients are healthy enough to mix
    loss: Optional[float] = None

    def pack(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def unpack(cls, d: dict) -> "LocalProgress":
        loss = d.get("loss")
        return cls(
            step=int(d["step"]),
            samples_accumulated=int(d["samples_accumulated"]),
            samples_per_second=float(d["samples_per_second"]),
            time=float(d["time"]),
            client_mode=bool(d.get("client_mode", False)),
            aux=bool(d.get("aux", False)),
            loss=float(loss) if loss is not None else None,
        )


@dataclass
class CollaborationState:
    optimizer_step: int
    samples_accumulated: int  # collaboration-wide, towards the NEXT step
    target_batch_size: int
    num_peers: int  # trainers only — aux presence is counted separately
    num_clients: int
    eta_next_step: float  # seconds
    next_fetch_time: float  # dht time
    num_aux: int = 0  # live aux peers expected to join averaging rounds
    # trainers whose reported step == optimizer_step: the peers that can
    # certainly JOIN the current round — these get the full straggler
    # window. A peer more than one behind fell out (it is resyncing state)
    # and cannot contribute; sizing groups on it stalls a full window +
    # averaging timeout per step (round-5 window sweep, docs/fleet.md).
    num_peers_at_step: int = 0
    # ...plus peers exactly ONE step behind: usually a partner that just
    # applied the previous round and reports its new step only at its next
    # boundary (progress records are seconds stale) — but possibly one
    # stuck retrying the PREVIOUS round that will never arrive. The leader
    # therefore gives near-step-only rounds a SHORT grace, not the full
    # window: a genuinely-arriving partner shows up within a couple of
    # refresh periods, a stuck one must not hold the collaboration hostage
    # (both failure shapes observed in the round-5 sweep).
    num_peers_near_step: int = 0
    # start the round this many samples EARLY so matchmaking latency
    # overlaps the tail of accumulation (the reference's batch_size_lead,
    # albert/arguments.py CollaborativeOptimizerArguments)
    batch_size_lead: int = 0
    # median advertised loss of the OTHER live trainers (nan when nobody
    # advertises one): the reference point for the trunk-health gate — a
    # peer whose own loss diverges far above this defers mixing
    median_other_loss: float = float("nan")

    @property
    def ready_for_step(self) -> bool:
        return (
            self.samples_accumulated
            >= self.target_batch_size - self.batch_size_lead
        )


class ProgressTracker:
    def __init__(
        self,
        dht: DHT,
        prefix: str,
        peer_subkey: bytes,
        target_batch_size: int,
        min_refresh_period: float = 0.5,
        max_refresh_period: float = 30.0,
        default_refresh_period: float = 3.0,
        metadata_expiration: float = 30.0,
        expected_drift_peers: float = 3.0,
        expected_drift_rate: float = 0.2,
        batch_size_lead: int = 0,
    ):
        if not 0 <= batch_size_lead < target_batch_size:
            # lead >= target would make every step ready at zero samples —
            # a busy-loop of zero-gradient optimizer steps; fail at startup
            raise ValueError(
                f"batch_size_lead ({batch_size_lead}) must be in "
                f"[0, target_batch_size={target_batch_size})"
            )
        self.dht = dht
        self.key = f"{prefix}_progress"
        self.peer_subkey = peer_subkey
        self.target_batch_size = target_batch_size
        self.batch_size_lead = batch_size_lead
        self.min_refresh_period = min_refresh_period
        self.max_refresh_period = max_refresh_period
        self.default_refresh_period = default_refresh_period
        self.metadata_expiration = metadata_expiration
        self.expected_drift_peers = expected_drift_peers
        self.expected_drift_rate = expected_drift_rate
        self._records: Optional[dict] = None  # subkey -> LocalProgress (DHT view)
        self._next_fetch: float = 0.0
        self._last_local: Optional[LocalProgress] = None

    def report_local_progress(self, progress: LocalProgress) -> None:
        """Fire-and-forget publish of this peer's accumulation state."""
        self._last_local = progress
        try:
            self.dht.store(
                self.key,
                progress.pack(),
                get_dht_time() + self.metadata_expiration,
                subkey=self.peer_subkey,
                return_future=True,  # don't block the training thread
            )
        except Exception as e:  # noqa: BLE001 — progress is best-effort
            logger.debug(f"progress report failed: {e!r}")

    def fetch_collaboration_state(self, force: bool = False) -> CollaborationState:
        """Aggregate everyone's progress.

        Remote records are cache-gated by the adaptive refresh period, but
        this peer's OWN latest progress is overlaid on every call — like the
        reference, a peer that accumulates the whole target batch by itself
        becomes ready_for_step immediately, without waiting for its own DHT
        write to round-trip or the refresh deadline to pass."""
        now = get_dht_time()
        fetched = False
        if force or self._records is None or now >= self._next_fetch:
            entry = self.dht.get(self.key, latest=True)
            by_subkey: dict = {}
            if entry is not None and hasattr(entry.value, "items"):
                for sk, v in entry.value.items():
                    try:
                        by_subkey[sk] = LocalProgress.unpack(v.value)
                    except Exception:  # noqa: BLE001 — malformed record
                        continue
            self._records = by_subkey
            fetched = True

        by_subkey = dict(self._records)
        if self._last_local is not None:
            stored = by_subkey.get(self.peer_subkey)
            if stored is None or stored.time <= self._last_local.time:
                by_subkey[self.peer_subkey] = self._last_local

        # aux presence records carry no training progress — they must not
        # drive optimizer_step (an aux's step can lead trainers briefly
        # around a round boundary, and letting it win the max would make
        # every trainer think it fell behind) nor the sample/throughput
        # totals; they only size averaging groups (num_aux)
        records = [r for r in by_subkey.values() if not r.aux]
        num_aux = sum(r.aux for r in by_subkey.values())
        # trunk-health reference: median advertised loss of the OTHER
        # trainers (own record excluded — with two peers, including self
        # would drag the median halfway toward the diverged joiner and
        # soften the very gate it feeds)
        other_losses = [
            r.loss
            for sk, r in by_subkey.items()
            if not r.aux
            and sk != self.peer_subkey
            and r.loss is not None
            and math.isfinite(r.loss)
        ]
        median_other_loss = (
            statistics.median(other_losses) if other_losses else float("nan")
        )
        max_step, total_samples, total_sps = 0, 0, 0.0
        num_peers = num_clients = num_at_step = num_near = 0
        if records:
            max_step = max(r.step for r in records)
        for r in records:
            num_peers += 1
            num_clients += bool(r.client_mode)
            total_sps += r.samples_per_second
            if r.step == max_step:
                total_samples += r.samples_accumulated
                num_at_step += 1
            if r.step >= max_step - 1:
                num_near += 1
        # throughput below the floor means "not yet measured" (a fresh peer's
        # EMA), NOT a multi-year ETA — treat the ETA as unknown so the refresh
        # period falls back to the default instead of pinning at the maximum
        # ETA to the READY point — target minus lead, so the adaptive poll
        # cadence tightens in time to catch the (earlier) round start
        eta = (
            max(
                0.0,
                self.target_batch_size - self.batch_size_lead - total_samples,
            ) / total_sps
            if num_peers and total_sps > 1e-6
            else float("inf")
        )
        if fetched:
            # adaptive refresh (arguments.py:29-41): poll faster near the step
            period = min(
                self.max_refresh_period,
                max(self.min_refresh_period, eta / 2 if eta != float("inf")
                    else self.default_refresh_period),
            )
            self._next_fetch = now + period
        return CollaborationState(
            optimizer_step=max_step,
            samples_accumulated=total_samples,
            target_batch_size=self.target_batch_size,
            num_peers=num_peers,
            num_clients=num_clients,
            num_aux=num_aux,
            num_peers_at_step=num_at_step,
            num_peers_near_step=num_near,
            eta_next_step=eta,
            next_fetch_time=self._next_fetch,
            batch_size_lead=self.batch_size_lead,
            median_other_loss=median_other_loss,
        )
