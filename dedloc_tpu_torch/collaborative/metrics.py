"""The signed metrics bus: per-peer training metrics over the DHT.

Capability parity with albert/metrics_utils.py:9-24: a pydantic
``LocalMetrics`` schema stored under ``{prefix}_metrics`` with one subkey per
peer, protected by RSA signature + schema validation so metrics are
spoof-resistant. The coordinator (roles/coordinator.py) aggregates these the
same way run_first_peer.py:176-218 does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from pydantic import BaseModel, StrictFloat, StrictInt, conint

from dedloc_tpu_torch.core.serialization import unpack_obj
from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.dht.crypto import RSAPrivateKey
from dedloc_tpu_torch.dht.dht import DHT
from dedloc_tpu_torch.dht.validation import (
    RecordValidatorBase,
    RSASignatureValidator,
    SchemaValidator,
)
from dedloc_tpu_torch.telemetry import registry as telemetry
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class LocalMetrics(BaseModel):
    """Reference: LocalMetrics(BaseModel) at albert/metrics_utils.py:9-15.

    The optional telemetry tail is the vissl PerfStats capability
    (vissl/utils/perf_stats.py:12-249) carried over the metrics bus: per-peer
    step-phase timings + HBM occupancy, aggregated by the coordinator into
    its JSONL. Optional so peers without telemetry enabled (and round-1
    records) still validate."""

    step: StrictInt
    samples_per_second: StrictFloat
    samples_accumulated: StrictInt
    loss: StrictFloat
    mini_steps: StrictInt
    step_time_ms: Optional[StrictFloat] = None  # accumulation-boundary wall
    data_wait_ms: Optional[StrictFloat] = None  # host input-pipeline stall
    allreduce_ms: Optional[StrictFloat] = None  # averaging round (stepped only)
    hbm_bytes: Optional[StrictInt] = None  # device bytes_in_use
    # swarm-telemetry snapshot (telemetry/registry.py Telemetry.snapshot):
    # flat {counter/gauge/histogram name: value} — the coordinator folds
    # these into its swarm-health record (telemetry/health.py). Optional so
    # peers with telemetry disabled (and pre-telemetry records) validate.
    # Per-link estimates ride the same dict as "link.<host:port>.<field>"
    # keys (telemetry/links.py), bounded to the busiest top-K links.
    telemetry: Optional[Dict[str, float]] = None
    # this peer's advertised RPC endpoint ("host:port"): lets the
    # coordinator resolve the link destinations OTHER peers report into
    # peer labels when folding the swarm topology record. Optional so
    # pre-link-telemetry records (and client-mode peers) validate.
    endpoint: Optional[str] = None
    # filled by fetch_metrics from the signed DHT subkey, never by peers:
    # a stable fingerprint so the coordinator can attribute stragglers
    peer: Optional[str] = None


class MetricSchema(BaseModel):
    """Shape of the full ``{prefix}_metrics`` dictionary value: one
    LocalMetrics per signed peer subkey (metrics_utils.py:17-18)."""

    metrics: Dict[str, LocalMetrics]


def make_validators(
    prefix: str, private_key: Optional[RSAPrivateKey] = None
) -> Tuple[List[RecordValidatorBase], bytes]:
    """[schema, signature] validator chain + this peer's public-key subkey
    (metrics_utils.py:21-24). The checkpoint-catalog schema rides the same
    chain: a malformed shard announcement is rejected at the storing node,
    and announcements published under a peer's owner-tag subkey are
    signature-bound to that peer (dedloc_tpu/checkpointing/catalog.py)."""
    from dedloc_tpu_torch.averaging.planwire import PlanRecord
    from dedloc_tpu_torch.checkpointing.catalog import CheckpointAnnouncement
    from dedloc_tpu_torch.serving.records import ExpertRecord
    from dedloc_tpu_torch.telemetry.ledger import ContributionClaim, RoundReceipt

    signature = RSASignatureValidator(private_key)
    schema = SchemaValidator(
        {
            "metrics": LocalMetrics,
            "checkpoint_catalog": CheckpointAnnouncement,
            # live re-planning records (averaging/planwire.py): a malformed
            # or out-of-range topology plan is rejected at the storing
            # node, not discovered mid-round by every adopting peer
            "topology_plan": PlanRecord,
            # contribution accounting (telemetry/ledger.py): claims and
            # round receipts are schema-checked at every storing node, so
            # the coordinator's fold never sees a structurally bad record
            "contribution_ledger": ContributionClaim,
            "round_receipts": RoundReceipt,
            # expert serving discovery (serving/records.py): a malformed
            # or identity-mismatched expert announcement is rejected at
            # the storing node, not discovered by a routing gateway
            "experts": ExpertRecord,
        },
        prefix=prefix,
    )
    return [schema, signature], signature.local_public_key


def publish_metrics(
    dht: DHT,
    prefix: str,
    subkey: bytes,
    metrics: LocalMetrics,
    expiration: float = 600.0,
) -> None:
    """Store this peer's metrics (statistics_expiration default matches
    albert/arguments.py:82-84)."""
    dht.store(
        f"{prefix}_metrics",
        metrics.model_dump(),
        get_dht_time() + expiration,
        subkey=subkey,
        return_future=True,
    )


# peers whose malformed metrics records were already reported: the drop is
# logged at WARNING once per peer (a wedged peer republishes every few
# seconds — repeating the warning each aggregation tick would bury the log),
# counted through the telemetry registry every time
_malformed_warned: set = set()


def fetch_metrics(dht: DHT, prefix: str) -> List[LocalMetrics]:
    """All currently-live peer metrics (coordinator view,
    run_first_peer.py:177-187). Malformed records are dropped, counted
    (``metrics.malformed_records``) and reported once per peer — a peer
    publishing garbage must be visible, not silently invisible."""
    entry = dht.get(f"{prefix}_metrics", latest=True)
    out: List[LocalMetrics] = []
    if entry is None or not hasattr(entry.value, "items"):
        return out
    import hashlib

    for subkey, v in entry.value.items():
        raw = subkey if isinstance(subkey, bytes) else str(subkey).encode()
        peer = hashlib.sha1(raw).hexdigest()[:12]
        try:
            payload = v.value
            if isinstance(payload, (bytes, bytearray)):
                payload = unpack_obj(payload)
            record = LocalMetrics.model_validate(payload)
            out.append(record.model_copy(update={"peer": peer}))
        except Exception as e:  # noqa: BLE001 — skip malformed peer records
            telemetry.inc("metrics.malformed_records")
            if peer not in _malformed_warned:
                if len(_malformed_warned) >= 4096:
                    # bound the memory on a churning fleet; clearing also
                    # re-arms the warning for a peer that regressed long
                    # after it was first reported
                    _malformed_warned.clear()
                _malformed_warned.add(peer)
                logger.warning(
                    f"dropping malformed metrics record from peer {peer}: "
                    f"{e!r} (reported once; further drops are only counted)"
                )
            continue
    return out


def aggregate_metrics(records: List[LocalMetrics]) -> Optional[dict]:
    """Coordinator aggregation (run_first_peer.py:188-200): alive peers,
    summed throughput/samples, loss averaged over mini-steps of the CURRENT
    global step."""
    if not records:
        return None
    current_step = max(m.step for m in records)
    current = [m for m in records if m.step == current_step]
    sum_mini = sum(m.mini_steps for m in current)
    sum_loss = sum(m.loss for m in current)
    agg = {
        "step": current_step,
        "alive_peers": len(records),
        "samples_accumulated": sum(m.samples_accumulated for m in current),
        "samples_per_second": sum(m.samples_per_second for m in records),
        "loss": (sum_loss / sum_mini) if sum_mini else 0.0,
        "mini_steps": sum_mini,
    }
    telemetry = [
        {
            "peer": m.peer,
            "samples_per_second": m.samples_per_second,
            "step_time_ms": m.step_time_ms,
            "data_wait_ms": m.data_wait_ms,
            "allreduce_ms": m.allreduce_ms,
            "hbm_bytes": m.hbm_bytes,
        }
        for m in current
        if m.step_time_ms is not None
    ]
    if telemetry:
        agg["peer_telemetry"] = telemetry
    return agg
