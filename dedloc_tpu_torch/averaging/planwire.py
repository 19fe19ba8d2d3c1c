"""Epoch-versioned topology plan records on the DHT (live re-planning wire).

The coordinator's closed adaptation loop (roles/coordinator.py) derives a
``TopologyPlan`` from its live link fold and publishes it here — one
dictionary record per collaboration at ``{prefix}_topology_plan``, one
subkey per publisher (the same signed-record machinery as the metrics bus
and the checkpoint catalog: when the subkey is the coordinator's RSA owner
tag the record is signature-bound to it; the ``PlanRecord`` schema below is
validated at every storing node either way, so a malformed or out-of-range
plan is rejected at the DHT boundary, not discovered mid-round).

Peers poll the record between rounds (``DecentralizedAverager.step`` →
``maybe_refresh_plan``) and adopt the highest-epoch valid plan. Adoption
needs no barrier and no handshake: matchmaking scopes embed the plan epoch
(``TopologyPlan.clique_scope``/``wan_scope``/``gossip_scope``), so peers on
epoch k and k+1 form disjoint groups during rollout and converge as fetches
land.

Failure ladder (the robustness contract this module is FOR):

- a transient DHT failure on publish or fetch costs one bounded
  exponential backoff (``plan_sync.retries`` counter + ``plan_sync.retry``
  event per attempt — same retry idiom as state sync), never a crash;
- a fetch that exhausts its retries, or a record that fails the schema,
  returns ``(None, reason)`` — the peer KEEPS its current plan;
- only after ``max_plan_fetch_failures`` consecutive fetch errors does the
  averager degrade to flat (averager.py names the reason in its
  ``avg.topology.fallback`` event) — a dead coordinator demotes the swarm
  to today's flat butterfly, it never strands it.

Fault point ``topology.plan_record`` (testing/faults.py) fires on every
publish/fetch attempt with ``op="publish"|"fetch"`` so tests script record
loss deterministically.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

from pydantic import BaseModel, StrictInt, model_validator

from dedloc_tpu_torch.averaging.topology import TopologyPlan
from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.testing import faults
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

PLAN_MODES = ("flat", "hierarchical", "gossip")

# actuation tuning keys a plan record may carry (the guard-railed retune's
# distribution channel; roles map them onto averager knobs). Unknown keys
# in a received record are ignored, so new knobs roll out coordinator-first.
TUNING_KEYS = ("chunk_size", "overlap")

# retry budget for one publish/fetch: attempt, then `PLAN_SYNC_RETRIES`
# retries at backoff * 2**(attempt-1) seconds — bounded, like state sync
PLAN_SYNC_RETRIES = 2
PLAN_SYNC_BACKOFF = 0.5

# a peer keeps its current plan through this many CONSECUTIVE failed
# fetches before degrading to flat (averager.py applies this)
MAX_PLAN_FETCH_FAILURES = 3

# plan records outlive several publish intervals so a briefly-partitioned
# peer still finds the current plan when it reconnects
PLAN_RECORD_EXPIRATION = 600.0


def plan_key(prefix: str) -> str:
    return f"{prefix}_topology_plan"


class PlanRecord(BaseModel):
    """Schema for one publisher's plan subkey (validated by the DHT's
    SchemaValidator chain, like the checkpoint catalog)."""

    epoch: StrictInt
    plan: Dict  # TopologyPlan.to_dict() payload
    issued: float  # dht time the coordinator derived this plan
    tuning: Optional[Dict] = None  # guard-railed actuation deltas

    @model_validator(mode="after")
    def _check(self) -> "PlanRecord":
        if self.epoch < 0:
            raise ValueError(f"negative epoch {self.epoch}")
        mode = self.plan.get("mode")
        if mode not in PLAN_MODES:
            raise ValueError(f"unknown plan mode {mode!r}")
        # the plan payload must round-trip the shared parser — a record a
        # storing node accepts but a peer cannot parse would strand that
        # peer mid-rollout
        parsed = TopologyPlan.from_dict(self.plan)
        if int(parsed.epoch) != int(self.epoch):
            raise ValueError(
                f"plan epoch {parsed.epoch} != record epoch {self.epoch}"
            )
        if mode == "hierarchical" and not parsed.cliques:
            raise ValueError("hierarchical plan with no cliques")
        if mode == "gossip" and len(parsed.peers) < 2:
            raise ValueError("gossip plan with fewer than 2 roster peers")
        if self.tuning is not None:
            for k, v in self.tuning.items():
                if not isinstance(k, str) or not isinstance(
                    v, (int, float, bool)
                ):
                    raise ValueError(f"non-scalar tuning entry {k!r}={v!r}")
        return self

    def topology_plan(self) -> TopologyPlan:
        return TopologyPlan.from_dict(self.plan)


def _backoff_sleep(attempt: int, backoff: float, op: str) -> None:
    delay = backoff * (2 ** (attempt - 1))
    telemetry.inc("plan_sync.retries")
    telemetry.event("plan_sync.retry", op=op, attempt=attempt,
                    backoff_s=delay)
    # runtime-only retry pacing: the simulator's closed loop drives the
    # control logic directly and never enters this module
    time.sleep(delay)


def publish_plan(
    dht,
    prefix: str,
    record: PlanRecord,
    subkey: bytes = b"coordinator",
    expiration: float = PLAN_RECORD_EXPIRATION,
    retries: int = PLAN_SYNC_RETRIES,
    backoff: float = PLAN_SYNC_BACKOFF,
) -> bool:
    """Store the coordinator's plan record, retrying transient DHT failures
    with bounded exponential backoff. Returns whether a store succeeded —
    False means every attempt failed and the swarm stays on its previous
    record (which is why records outlive several publish intervals)."""
    for attempt in range(retries + 1):
        if attempt:
            _backoff_sleep(attempt, backoff, "publish")
        try:
            if faults._active is not None:
                fault = faults.fire(
                    "topology.plan_record", op="publish",
                    epoch=int(record.epoch),
                )
                if fault is not None:
                    if fault.action == "drop":
                        # the record is lost in flight: this attempt
                        # "succeeds" locally but stores nothing
                        continue
                    raise OSError("fault injected: plan publish failed")
            ok = dht.store(
                plan_key(prefix),
                record.model_dump(),
                get_dht_time() + expiration,
                subkey=subkey,
            )
            if ok:
                return True
        except Exception as e:  # noqa: BLE001 — a DHT blip is retried
            logger.warning(
                f"plan publish attempt {attempt + 1} failed: {e!r}"
            )
    return False


def parse_plan_entries(entry_items) -> Tuple[Optional[PlanRecord], str]:
    """THE one parsing path for plan records: validate every subkey entry,
    keep the highest epoch, name why nothing was adoptable otherwise.
    ``entry_items`` is an iterable of (subkey, unpacked record dict)."""
    best: Optional[PlanRecord] = None
    reasons = []
    for sk, value in entry_items:
        try:
            rec = PlanRecord.model_validate(value)
        except Exception as e:  # noqa: BLE001 — malformed record named
            reasons.append(f"unparseable plan record: {e!r}")
            logger.debug(f"dropping malformed plan record {sk!r}: {e!r}")
            continue
        if best is None or rec.epoch > best.epoch:
            best = rec
    if best is not None:
        return best, ""
    return None, (reasons[-1] if reasons else "no plan record published")


def fetch_plan(
    dht,
    prefix: str,
    retries: int = PLAN_SYNC_RETRIES,
    backoff: float = PLAN_SYNC_BACKOFF,
) -> Tuple[Optional[PlanRecord], str]:
    """Fetch the newest valid plan record, retrying transient DHT failures
    with bounded exponential backoff. Returns ``(record, "")`` or
    ``(None, reason)`` — the caller decides whether the reason means "keep
    the current plan" (transient) or "degrade to flat" (repeated)."""
    reason = "no plan record published"
    for attempt in range(retries + 1):
        if attempt:
            _backoff_sleep(attempt, backoff, "fetch")
        try:
            if faults._active is not None:
                fault = faults.fire("topology.plan_record", op="fetch")
                if fault is not None:
                    if fault.action == "drop":
                        reason = "plan record lost (fault injected)"
                        continue
                    raise OSError("fault injected: plan fetch failed")
            entry = dht.get(plan_key(prefix), latest=True)
        except Exception as e:  # noqa: BLE001 — a DHT blip is retried
            reason = f"plan fetch failed: {e!r}"
            logger.warning(
                f"plan fetch attempt {attempt + 1} failed: {e!r}"
            )
            continue
        if entry is None or not isinstance(entry.value, dict):
            # an empty record is definitive, not a transient failure: the
            # coordinator has simply not published (or it expired)
            return None, "no plan record published"
        record, parse_reason = parse_plan_entries(
            (sk, v.value) for sk, v in entry.value.items()
        )
        if record is not None:
            return record, ""
        reason = parse_reason
    return None, reason
