"""The signed contribution ledger: receipt-backed swarm accounting.

Every sample count in the progress tracker is self-reported; the ledger
makes contribution accounting *checkable* with two signed DHT record
families riding the same validator chain as the checkpoint catalog
(collaborative/metrics.py ``make_validators``):

- ``{prefix}_contribution_ledger`` — one ``ContributionClaim`` per peer
  (subkey = the peer's RSA owner tag, so the record is signature-bound):
  cumulative samples accumulated, rounds completed, wall-seconds trained,
  and bytes served as a checkpoint/state provider. Claims are what a peer
  SAYS it did.
- ``{prefix}_round_receipts`` — one ``RoundReceipt`` per peer, refreshed
  at each averaging-round finalization: the last round's member set and
  declared weights (signed over the matchmaking envelope identities the
  signer already verified at join time) plus a bounded cumulative
  ``witness`` table — how many declared samples this signer has watched
  each group-mate bring across all rounds so far. Receipts are what the
  swarm SAW a peer do.

The coordinator folds one against the other (``fold_ledger``): a peer's
credited samples are ``min(claimed, receipt-supported x slack)``, where
receipt-supported is the largest witness total any OTHER peer countersigns
for it — so a peer cannot be credited for samples no group-mate ever saw,
and an inflated claim surfaces as a named per-peer ``discrepancy``. A peer
whose claim record was lost but whose work was witnessed is credited its
witnessed total (receipts are evidence, not just a cap). The fold is
deterministic for fixed inputs — replaying a dumped ledger JSONL must
reproduce it bit-identically.

Both record families are cumulative by construction: an RSA-validated
subkey must be exactly the owner tag (dht/validation.py), so each peer has
ONE slot per family and every store is a last-write-wins refresh — there
is no per-round record to garbage-collect.

Identity binding: the ``peer``/``signer`` field inside a record is only
trusted when it matches the identity its storage slot speaks for
(``subkey_owner_id``): an RSA owner-tag subkey binds to the key digest
gated matchmaking already uses as the peer id
(core/auth.peer_id_from_public_key), a raw-bytes subkey binds to itself.
``parse_claims``/``parse_receipts`` DROP any record that fails the
binding, so a peer cannot publish, under its own valid slot, a claim
naming a victim or a receipt whose fabricated ``signer`` launders a
witness table crediting itself.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

from pydantic import BaseModel, StrictInt, StrictStr, model_validator

from dedloc_tpu_torch.core.auth import peer_id_from_public_key
from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.dht.validation import OWNER_PREFIX
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# witness-table bound: a receipt must stay a small DHT record even after a
# peer has averaged with thousands of partners — keep the top entries by
# witnessed samples (the tail it drops is exactly the tail that cannot
# support a large claim anyway)
MAX_WITNESS = 512

# default over-claim slack: claims run ahead of receipts by up to one
# publication period (samples accumulated since the last receipted round),
# so the fold tolerates a bounded multiplicative lead before it flags
DEFAULT_SLACK = 1.25

LEGS = ("flat", "gossip", "clique")


_STEP_RE = re.compile(r"step[_-]?(\d+)")


def parse_round_step(round_id: str) -> int:
    """Optimizer step encoded in a round id (the collaborative optimizer
    keys rounds ``step{N}``); -1 when the id carries none (bare averager
    or simulator rounds)."""
    m = _STEP_RE.search(str(round_id))
    return int(m.group(1)) if m else -1


def ledger_key(prefix: str) -> str:
    return f"{prefix}_contribution_ledger"


def receipts_key(prefix: str) -> str:
    return f"{prefix}_round_receipts"


def _finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(float(x))


class ContributionClaim(BaseModel):
    """One peer's cumulative self-report (validated at every storing node
    by the DHT's SchemaValidator chain, like the checkpoint catalog)."""

    peer: StrictStr  # averager peer_id, hex — joins claims to receipts
    samples: StrictInt  # cumulative samples accumulated
    rounds: StrictInt  # cumulative averaging rounds completed
    train_seconds: float  # wall-seconds since the optimizer came up
    bytes_served: StrictInt  # ckpt.shard_bytes_served + state.served_bytes
    # inference requests served from the expert-serving plane
    # (serving/host.py) — optional with a 0 default so pre-serving claim
    # records keep parsing unchanged
    requests_served: StrictInt = 0
    time: float  # publication stamp (DHT clock)

    @model_validator(mode="after")
    def _check(self) -> "ContributionClaim":
        if not self.peer or len(self.peer) > 128:
            raise ValueError(f"bad peer id {self.peer!r}")
        if (
            self.samples < 0 or self.rounds < 0
            or self.bytes_served < 0 or self.requests_served < 0
        ):
            raise ValueError("claim totals must be non-negative")
        if not _finite(self.train_seconds) or self.train_seconds < 0:
            raise ValueError(f"bad train_seconds {self.train_seconds!r}")
        if not _finite(self.time):
            raise ValueError(f"bad time {self.time!r}")
        return self


class WitnessEntry(BaseModel):
    """What one signer has cumulatively watched one group-mate declare."""

    samples: float  # sum of the mate's declared weights across rounds
    rounds: StrictInt  # rounds the signer shared a group with the mate

    @model_validator(mode="after")
    def _check(self) -> "WitnessEntry":
        if not _finite(self.samples) or self.samples < 0:
            raise ValueError(f"bad witnessed samples {self.samples!r}")
        if self.rounds < 0:
            raise ValueError(f"negative witnessed rounds {self.rounds}")
        return self


class RoundReceipt(BaseModel):
    """One peer's countersignature over its last finalized round plus its
    cumulative witness table. ``members``/``weights`` are aligned and cover
    the matchmaking identities the signer verified (gated runs: each
    member's record arrived in an authority-signed envelope bound to that
    identity); delegates in hierarchical mode countersign their clique's
    SUM leg (``leg="clique"``)."""

    signer: StrictStr  # hex peer id; parse_receipts drops any record
    # whose signer does not match its storage slot (subkey_owner_id)
    round_id: StrictStr
    step: StrictInt  # optimizer step parsed from the round id (-1 unknown)
    leg: StrictStr  # flat | gossip | clique
    members: List[StrictStr]  # hex ids, strictly sorted + unique
    weights: List[float]  # declared weights, aligned with ``members``
    witness: Dict[str, WitnessEntry]
    time: float

    @model_validator(mode="after")
    def _check(self) -> "RoundReceipt":
        if self.leg not in LEGS:
            raise ValueError(f"unknown receipt leg {self.leg!r}")
        if self.step < -1:
            raise ValueError(f"bad step {self.step}")
        if len(self.members) < 2:
            raise ValueError("a receipt needs >= 2 members")
        if len(self.members) > 4096:
            raise ValueError(f"absurd member count {len(self.members)}")
        if self.members != sorted(set(self.members)):
            raise ValueError("members must be strictly sorted and unique")
        if len(self.weights) != len(self.members):
            raise ValueError("weights must align with members")
        if self.signer not in self.members:
            raise ValueError("signer must be a group member")
        for w in self.weights:
            if not _finite(w) or w < 0:
                raise ValueError(f"bad declared weight {w!r}")
        if len(self.witness) > MAX_WITNESS:
            raise ValueError(
                f"witness table over bound ({len(self.witness)} > "
                f"{MAX_WITNESS})"
            )
        if not _finite(self.time):
            raise ValueError(f"bad time {self.time!r}")
        return self


# ------------------------------------------------------------ publication


def publish_claim(dht, prefix: str, subkey: bytes,
                  claim: ContributionClaim,
                  expiration: float = 300.0) -> None:
    """Store this peer's claim record (non-blocking, like the catalog
    announcement it rides next to)."""
    dht.store(
        ledger_key(prefix),
        claim.model_dump(),
        get_dht_time() + expiration,
        subkey=subkey,
        return_future=True,
    )


def publish_receipt(dht, prefix: str, subkey: bytes,
                    receipt: RoundReceipt,
                    expiration: float = 300.0) -> None:
    dht.store(
        receipts_key(prefix),
        receipt.model_dump(),
        get_dht_time() + expiration,
        subkey=subkey,
        return_future=True,
    )


def subkey_owner_id(subkey) -> Optional[str]:
    """The ONE peer id a ledger record stored under ``subkey`` may speak
    for. An RSA owner tag (dht/validation.py: the only subkey shape whose
    writes are signature-checked at storing nodes) binds cryptographically
    to the key-digest id gated matchmaking already enforces as the peer
    identity (core/auth.peer_id_from_public_key). A raw-bytes subkey binds
    structurally to itself — the open-swarm trust model, where node ids
    are free and unsigned slots are writable by anyone. None = unbindable
    shape; callers must drop the record."""
    if isinstance(subkey, str):
        subkey = subkey.encode()
    if not isinstance(subkey, (bytes, bytearray)):
        return None
    subkey = bytes(subkey)
    if subkey.startswith(OWNER_PREFIX):
        try:
            return peer_id_from_public_key(subkey[len(OWNER_PREFIX):]).hex()
        except Exception:  # noqa: BLE001 — undigestible tag
            return None
    return subkey.hex()


def parse_claims(entry_items) -> List[ContributionClaim]:
    """THE one parsing path for claim records: drop anything that fails
    the schema (defense in depth — a storing node that predates the schema
    may have accepted garbage) and anything whose ``peer`` does not match
    the identity its subkey speaks for (``subkey_owner_id``) — a peer
    cannot publish a claim naming somebody else under its own slot.
    ``entry_items`` iterates (subkey, unpacked claim dict)."""
    out: List[ContributionClaim] = []
    for sk, value in entry_items:
        try:
            claim = ContributionClaim.model_validate(value)
        except Exception as e:  # noqa: BLE001 — malformed claim
            logger.debug(f"dropping malformed claim record: {e!r}")
            continue
        owner = subkey_owner_id(sk)
        if owner != claim.peer:
            logger.debug(
                f"dropping claim for {claim.peer!r}: its slot speaks for "
                f"{owner!r}"
            )
            continue
        out.append(claim)
    return out


def parse_receipts(entry_items) -> List[RoundReceipt]:
    """Same hardening for receipts: a record whose ``signer`` is not the
    identity its subkey speaks for is DROPPED before the fold ever sees
    its witness table — otherwise a peer could countersign its own work
    under a fabricated signer id and bypass the self-witness skip."""
    out: List[RoundReceipt] = []
    for sk, value in entry_items:
        try:
            receipt = RoundReceipt.model_validate(value)
        except Exception as e:  # noqa: BLE001 — malformed receipt
            logger.debug(f"dropping malformed receipt record: {e!r}")
            continue
        owner = subkey_owner_id(sk)
        if owner != receipt.signer:
            logger.debug(
                f"dropping receipt signed {receipt.signer!r}: its slot "
                f"speaks for {owner!r}"
            )
            continue
        out.append(receipt)
    return out


# --------------------------------------------------------------- witness


def update_witness(witness: Dict[str, Dict[str, float]],
                   mates: Iterable[Tuple[str, float]]) -> None:
    """Fold one finalized round's group-mates into a signer's cumulative
    witness table in place. ``mates`` iterates (peer_hex, declared_weight)
    for every OTHER member of the group. Bounded to ``MAX_WITNESS``
    entries by witnessed samples — the droppable tail is the set of peers
    whose totals could not support a meaningful claim anyway."""
    for peer, weight in mates:
        entry = witness.setdefault(peer, {"samples": 0.0, "rounds": 0})
        entry["samples"] = float(entry["samples"]) + max(0.0, float(weight))
        entry["rounds"] = int(entry["rounds"]) + 1
    if len(witness) > MAX_WITNESS:
        keep = sorted(
            witness.items(),
            key=lambda kv: (-float(kv[1]["samples"]), kv[0]),
        )[:MAX_WITNESS]
        witness.clear()
        witness.update(keep)


def receipt_from_group(signer_hex: str, round_id: str, step: int, leg: str,
                       member_weights: List[Tuple[str, float]],
                       witness: Dict[str, Dict[str, float]],
                       now: Optional[float] = None) -> RoundReceipt:
    """Build the signer's refreshed receipt after updating its witness
    table with the round just finalized. ``member_weights`` lists every
    group member (including the signer) as (peer_hex, declared_weight)."""
    update_witness(
        witness,
        [(p, w) for p, w in member_weights if p != signer_hex],
    )
    ordered = sorted({p: float(w) for p, w in member_weights}.items())
    return RoundReceipt(
        signer=signer_hex,
        round_id=str(round_id),
        step=int(step),
        leg=str(leg),
        members=[p for p, _w in ordered],
        weights=[round(w, 6) for _p, w in ordered],
        witness={
            p: WitnessEntry(
                samples=round(float(e["samples"]), 6),
                rounds=int(e["rounds"]),
            )
            for p, e in sorted(witness.items())
        },
        time=float(now if now is not None else get_dht_time()),
    )


# ------------------------------------------------------------------ fold


def fold_ledger(prev: Optional[Dict[str, Any]],
                claims: List[ContributionClaim],
                receipts: List[RoundReceipt],
                slack: float = DEFAULT_SLACK,
                now: Optional[float] = None) -> Dict[str, Any]:
    """One coordinator fold of claims against receipts into the durable
    cumulative ledger state. Restart-safe last-state-wins: both record
    families are cumulative, so a peer present in the current DHT view
    fully supersedes its ``prev`` entry, and a peer whose records expired
    keeps its ``prev`` entry (with a coverage note) instead of vanishing.

    Receipt support is MONOTONE for peers still in the view: receipts
    expire (~300s) long before claims stop refreshing, so a long-running
    peer whose former group-mates left would otherwise flip to
    "unwitnessed" and lose all credit. The ``prev`` fold's
    ``supported_samples``/``supported_rounds`` floor the current support
    (both families are cumulative, so the max is sound); a peer covered
    only by that carried floor is marked ``coverage="carried"`` — still
    capped, never falsely flagged.

    Deterministic for fixed inputs: peers fold in sorted order and floats
    are rounded, so replaying a dumped ledger JSONL reproduces the state
    bit-identically (the acceptance bar)."""
    t = float(now if now is not None else get_dht_time())
    slack = float(slack)
    # receipt-supported totals: the LARGEST witness any other signer
    # countersigns (witness tables are cumulative maxima, not addable —
    # summing two signers' tables would double-count shared rounds)
    supported: Dict[str, Dict[str, float]] = {}
    for r in receipts:
        for peer, entry in r.witness.items():
            if peer == r.signer:
                continue  # self-witness is just the claim again
            cur = supported.setdefault(peer, {"samples": 0.0, "rounds": 0})
            cur["samples"] = max(cur["samples"], float(entry.samples))
            cur["rounds"] = max(cur["rounds"], int(entry.rounds))
    have_receipts = bool(receipts)
    prev_peers = dict((prev or {}).get("peers") or {})

    def _floor(peer: str) -> Tuple[float, int]:
        """Receipt support carried from the prev fold (0,0 when the peer
        was never receipt-covered — pre-ledger entries carry None)."""
        old = prev_peers.get(peer)
        if not isinstance(old, dict):
            return 0.0, 0
        s = old.get("supported_samples")
        if not isinstance(s, (int, float)):
            return 0.0, 0
        r = old.get("supported_rounds")
        if not isinstance(r, (int, float)):
            r = old.get("credited_rounds") or 0  # pre-field ledger rows
        return float(s), int(r)

    peers: Dict[str, Dict[str, Any]] = {}
    for claim in sorted(claims, key=lambda c: (c.peer, -c.time)):
        if claim.peer in peers:
            continue  # first (latest) claim per peer wins
        sup = supported.get(claim.peer)
        floor_s, floor_r = _floor(claim.peer)
        eff_s = max(sup["samples"] if sup else 0.0, floor_s)
        eff_r = max(sup["rounds"] if sup else 0, floor_r)
        witnessed = sup is not None or floor_s > 0 or floor_r > 0
        entry: Dict[str, Any] = {
            "peer": claim.peer,
            "claimed_samples": int(claim.samples),
            "claimed_rounds": int(claim.rounds),
            "train_seconds": round(float(claim.train_seconds), 3),
            "bytes_served": int(claim.bytes_served),
            "requests_served": int(claim.requests_served),
            "last_claim_t": round(float(claim.time), 3),
            "discrepancy": None,
        }
        if not have_receipts and not witnessed:
            # pre-ledger swarm: no receipt evidence exists anywhere, now
            # or in any prior fold — credit as claimed, say so
            entry["coverage"] = "pre-ledger"
            entry["supported_samples"] = None
            entry["supported_rounds"] = None
            entry["credited_samples"] = int(claim.samples)
            entry["credited_rounds"] = int(claim.rounds)
        elif not witnessed:
            # receipts exist but nobody (current or prior fold) witnessed
            # this peer: a non-zero claim is unsupported — named, zero
            entry["coverage"] = "unwitnessed"
            entry["supported_samples"] = 0.0
            entry["supported_rounds"] = 0
            entry["credited_samples"] = 0
            entry["credited_rounds"] = 0
            if claim.samples > 0:
                entry["discrepancy"] = {
                    "kind": "unwitnessed",
                    "claimed_samples": int(claim.samples),
                    "supported_samples": 0.0,
                }
        else:
            cap = eff_s * slack
            credited = min(float(claim.samples), cap)
            entry["coverage"] = "receipts" if sup is not None else "carried"
            entry["supported_samples"] = round(eff_s, 3)
            entry["supported_rounds"] = int(eff_r)
            entry["credited_samples"] = int(round(credited))
            entry["credited_rounds"] = min(
                int(claim.rounds), int(eff_r * slack) + 1
            )
            if float(claim.samples) > cap:
                entry["discrepancy"] = {
                    "kind": "overclaim",
                    "claimed_samples": int(claim.samples),
                    "supported_samples": round(eff_s, 3),
                    "ratio": round(
                        float(claim.samples) / max(eff_s, 1e-9),
                        3,
                    ),
                }
        peers[claim.peer] = entry
    # witnessed-but-claimless peers: their claim record was lost or they
    # never published one, but group-mates countersigned their work —
    # credit the witnessed total (receipts are evidence, not just a cap)
    for peer in sorted(supported):
        if peer in peers:
            continue
        sup = supported[peer]
        if sup["samples"] <= 0 and sup["rounds"] <= 0:
            continue
        floor_s, floor_r = _floor(peer)
        eff_s = max(sup["samples"], floor_s)
        eff_r = max(int(sup["rounds"]), floor_r)
        peers[peer] = {
            "peer": peer,
            "claimed_samples": 0,
            "claimed_rounds": 0,
            "train_seconds": 0.0,
            "bytes_served": 0,
            "requests_served": 0,
            "last_claim_t": None,
            "coverage": "receipts-only",
            "supported_samples": round(eff_s, 3),
            "supported_rounds": int(eff_r),
            "credited_samples": int(round(eff_s)),
            "credited_rounds": int(eff_r),
            "discrepancy": None,
        }
    # restart-safe carry-over: peers whose records expired keep their last
    # folded state, flagged stale so the view can say why
    for peer, old in sorted(((prev or {}).get("peers") or {}).items()):
        if peer not in peers and isinstance(old, dict):
            kept = dict(old)
            kept["coverage"] = "stale"
            peers[peer] = kept

    ordered = {p: peers[p] for p in sorted(peers)}
    total = sum(int(e.get("credited_samples") or 0) for e in ordered.values())
    return {
        "t": round(t, 3),
        "slack": round(slack, 4),
        "claims": len(claims),
        "receipt_signers": len({r.signer for r in receipts}),
        "total_credited_samples": total,
        "discrepancies": sum(
            1 for e in ordered.values() if e.get("discrepancy")
        ),
        "peers": ordered,
    }


def leaderboard(ledger: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The ledger state as ranked leaderboard rows — THE one ranking both
    ``runlog_summary --contributions`` and ``swarm_watch --brief`` render,
    so the two surfaces can never disagree about who is on top."""
    entries = list((ledger.get("peers") or {}).values())
    total = float(
        sum(int(e.get("credited_samples") or 0) for e in entries)
    )
    rows: List[Dict[str, Any]] = []
    for e in sorted(
        entries,
        key=lambda e: (
            -int(e.get("credited_samples") or 0),
            -int(e.get("bytes_served") or 0),
            -int(e.get("requests_served") or 0),
            str(e.get("peer")),
        ),
    ):
        credited = int(e.get("credited_samples") or 0)
        rows.append({
            "peer": e.get("peer"),
            "credited_samples": credited,
            "claimed_samples": int(e.get("claimed_samples") or 0),
            "credited_rounds": int(e.get("credited_rounds") or 0),
            "bytes_served": int(e.get("bytes_served") or 0),
            "requests_served": int(e.get("requests_served") or 0),
            "share": round(credited / total, 4) if total > 0 else 0.0,
            "coverage": e.get("coverage"),
            "discrepancy": e.get("discrepancy"),
        })
    return rows
