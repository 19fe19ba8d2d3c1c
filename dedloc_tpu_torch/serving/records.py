"""Expert discovery: who serves which expert shard, at what load.

One dictionary record per collaboration at ``{prefix}_experts``, one subkey
per hosting peer — the same signed-record machinery as the checkpoint
catalog and the contribution ledger (collaborative/metrics.py
``make_validators``): the ``ExpertRecord`` schema is validated at every
storing node, and when the subkey is a peer's RSA owner tag the record is
signature-bound to that peer. A record says: "at ``endpoint`` I serve these
expert shards (id, weight version, per-window token capacity, recent load
EWMA)". Because a peer owns exactly ONE subkey slot, hosting several
experts means one record listing several ``ExpertEntry`` rows; every store
is a last-write-wins refresh carrying the live load numbers, so discovery
and load reporting are the same write.

Identity binding mirrors the ledger (telemetry/ledger.subkey_owner_id): the
``peer`` field inside a record is only trusted when it matches the identity
its storage slot speaks for; ``parse_expert_records`` DROPS any record that
fails the binding, so a peer cannot advertise endpoints under a victim's
identity from its own valid slot.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

from pydantic import BaseModel, StrictInt, StrictStr, model_validator

from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.telemetry.ledger import subkey_owner_id
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# a hosting peer keeps its slot refreshed well inside this window; a
# crashed host's record ages out in one discovery refresh period
DEFAULT_EXPERT_TTL = 30.0

# bound on experts one record may list: the DHT record must stay small
# (the catalog's sizing discipline) even for a fat peer hosting many shards
MAX_EXPERTS_PER_RECORD = 256


def experts_key(prefix: str) -> str:
    return f"{prefix}_experts"


def _finite(x: Any) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(float(x))


class ExpertEntry(BaseModel):
    """One hosted expert shard inside a peer's ``ExpertRecord``."""

    expert_id: StrictInt  # index into the MoE expert axis
    version: StrictInt  # checkpoint step the expert weights came from
    capacity: StrictInt  # max tokens admitted per dispatch window
    load_ewma: float  # recent tokens/s EWMA (the router's load signal)

    @model_validator(mode="after")
    def _check(self) -> "ExpertEntry":
        if self.expert_id < 0:
            raise ValueError(f"negative expert_id {self.expert_id}")
        if self.version < 0:
            raise ValueError(f"negative version {self.version}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if not _finite(self.load_ewma) or self.load_ewma < 0:
            raise ValueError(f"bad load_ewma {self.load_ewma!r}")
        return self


class ExpertRecord(BaseModel):
    """One hosting peer's subkey slot (validated by the DHT's
    SchemaValidator chain — see collaborative/metrics.py)."""

    peer: StrictStr  # peer id, hex — must match the slot's bound identity
    endpoint: List  # [host, port] — the peer's RPC endpoint
    experts: List[ExpertEntry]
    time: float  # publication stamp (DHT clock)

    @model_validator(mode="after")
    def _check(self) -> "ExpertRecord":
        if not self.peer or len(self.peer) > 128:
            raise ValueError(f"bad peer id {self.peer!r}")
        if (
            len(self.endpoint) != 2
            or not isinstance(self.endpoint[0], str)
            or not isinstance(self.endpoint[1], int)
        ):
            raise ValueError(f"endpoint must be [host, port]: {self.endpoint}")
        if not self.experts:
            raise ValueError("record must list at least one expert")
        if len(self.experts) > MAX_EXPERTS_PER_RECORD:
            raise ValueError(
                f"record lists {len(self.experts)} experts "
                f"(bound {MAX_EXPERTS_PER_RECORD})"
            )
        seen = set()
        for e in self.experts:
            if e.expert_id in seen:
                raise ValueError(f"duplicate expert_id {e.expert_id}")
            seen.add(e.expert_id)
        if not _finite(self.time):
            raise ValueError(f"bad time {self.time!r}")
        return self


def parse_expert_records(
    items: Iterable[Tuple[Any, Any]],
) -> List[ExpertRecord]:
    """(subkey, value) pairs from the ``{prefix}_experts`` dictionary entry
    -> identity-bound ``ExpertRecord`` list. A record whose ``peer`` does
    not match the identity its subkey speaks for is DROPPED (same rule as
    ledger claims), as is anything structurally invalid — a validating
    storing node already rejected those, but a reader must not trust that
    every replica validated."""
    out: List[ExpertRecord] = []
    for subkey, value in items:
        owner = subkey_owner_id(subkey)
        if owner is None:
            continue
        try:
            record = ExpertRecord.model_validate(value)
        except Exception:  # noqa: BLE001 — malformed record, drop
            logger.debug(f"dropping malformed expert record under {owner}")
            continue
        if record.peer != owner:
            logger.warning(
                f"dropping expert record naming {record.peer} stored under "
                f"slot bound to {owner}"
            )
            continue
        out.append(record)
    return out


def expert_directory(
    records: Iterable[ExpertRecord],
) -> Dict[int, List[Tuple[ExpertRecord, ExpertEntry]]]:
    """expert_id -> hosting (record, entry) pairs, one per peer (the
    latest record per peer wins), deterministically ordered by peer id so
    every reader of the same DHT view ranks candidates identically."""
    latest: Dict[str, ExpertRecord] = {}
    for record in records:
        held = latest.get(record.peer)
        if held is None or record.time >= held.time:
            latest[record.peer] = record
    directory: Dict[int, List[Tuple[ExpertRecord, ExpertEntry]]] = {}
    for peer in sorted(latest):
        record = latest[peer]
        for entry in record.experts:
            directory.setdefault(entry.expert_id, []).append((record, entry))
    return directory


async def publish_expert_record(
    node,
    prefix: str,
    record: ExpertRecord,
    subkey: bytes,
    expiration: float = DEFAULT_EXPERT_TTL,
) -> bool:
    """Store this peer's expert slot on a ``DHTNode`` (async path — the
    simulator and any in-loop host). Role code holding the threaded ``DHT``
    wrapper uses ``dht.store`` with the same arguments instead."""
    return await node.store(
        experts_key(prefix).encode(),
        record.model_dump(),
        get_dht_time() + expiration,
        subkey=subkey,
    )


class LoadEWMA:
    """Tokens-per-second load estimate with exponential decay — the
    ``load_ewma`` field a host publishes and the router ranks by.

    Decay is applied lazily on read/update against the virtual-time-safe
    clock the caller supplies (``timeutils.monotonic`` in production, the
    engine clock under the simulator), so an idle host's advertised load
    drains toward zero without a background task."""

    def __init__(self, clock, half_life_s: float = 10.0):
        self._clock = clock
        self._half_life = max(1e-6, float(half_life_s))
        self._value = 0.0
        self._t = float(clock())

    def _decay(self, now: float) -> None:
        dt = max(0.0, now - self._t)
        if dt > 0:
            self._value *= 0.5 ** (dt / self._half_life)
            self._t = now

    def observe(self, tokens: float) -> float:
        """Record ``tokens`` worth of work arriving now; returns the
        updated rate estimate."""
        now = float(self._clock())
        self._decay(now)
        # a burst of T tokens spread over one half-life
        self._value += float(tokens) / self._half_life
        return self._value

    def value(self) -> float:
        self._decay(float(self._clock()))
        return self._value
