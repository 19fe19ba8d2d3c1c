"""Coordinator-side swarm-health aggregation.

Per-peer telemetry snapshots ride the signed DHT metrics bus
(``LocalMetrics.telemetry``, one RSA-signed subkey per peer — spoof-
resistant, so a peer cannot blame its retries on someone else). The
coordinator folds them into ONE swarm-health record per aggregation tick,
appended to its metrics JSONL next to the throughput aggregate: straggler
attribution, per-peer retry/fault rates, and round-formation latency — the
"why was step N slow" view the reference could only answer by reading every
volunteer's stderr.

Record shape (see docs/observability.md):

    {"current_step": N,
     "peers": [{"peer": "ab12…", "step": N, "behind": 0,
                "rpc_failures": 0.0, "rounds_attempted": 3.0,
                "phases": {"data_wait": 0.01, "fwd_bwd": 0.4, ...},  # mean s
                "dominant_phase": "fwd_bwd", "mfu": 0.57,
                "overlap_efficiency": 0.93, ...}, ...],
     "straggler": "<peer label of the worst offender, or None>",
     "retry_rate": <state-sync retries / attempts, swarm-wide>,
     "round_formation_s": <mean mm.form_group latency across peers>,
     "faults_injected": <total fault events (test harnesses only)>}

The ``phases``/``dominant_phase``/``mfu``/``overlap_*`` fields come from the
step-phase flight recorder (``telemetry/steps.py``); peers on pre-recorder
builds simply lack them — their rows fold unchanged.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from dedloc_tpu_torch.telemetry import events

# ---------------------------------------------------------------------------
# Shared rule thresholds: ONE definition consumed by the swarm-health verdict
# below, the live watchdog (telemetry/watch.py) and the runlog_summary
# --health header — the live view and the post-hoc view can never disagree
# about what counts as DEGRADED because they read the same numbers.
# ---------------------------------------------------------------------------
RULE_THRESHOLDS: Dict[str, float] = {
    # aborted matchmaking rounds per attempted round (swarm-wide)
    "round_abort_rate": 0.25,
    # form_group attempts that never produced a group, per attempt.
    # NOT raw mm.join_failures: those count internal leader-race retries,
    # which run ~7x per formed round on a perfectly healthy contended
    # flat swarm (the ROADMAP-item-1 contention measurement) — an attempt
    # that eventually forms is a success, however many retries it took
    "join_failure_rate": 0.5,
    # connection deaths per minute, swarm-wide (needs timestamps; callers
    # without a time axis skip this rule rather than guess)
    "conns_lost_per_min": 6.0,
    # one peer's connection deaths per RPC call — a flapping NAT/firewall
    "peer_loss_ratio": 0.05,
    # steps behind the swarm before a peer is attributed (the existing
    # straggler semantics: behind==1 is publish skew, not a stall)
    "behind_steps": 2.0,
}

# counter names lifted from the instrumented seams — imported from the
# generated telemetry catalog (telemetry/events.py) so the dedlint schema
# checker guards ONE definition instead of duplicated string literals; a
# missing key reads 0.0 so peers running older builds (no telemetry tail)
# still aggregate
_PEER_COUNTERS = {
    "rpc_failures": events.RPC_CLIENT_FAILURES,
    "rpc_calls": events.RPC_CLIENT_CALLS,
    # connection-death count: with rpc_calls it gives the per-peer loss
    # rate a telemetry-fitted simulator model (dedloc_tpu/twin) reads
    "conns_lost": events.RPC_CONNS_LOST,
    "rounds_attempted": events.MM_ROUNDS_ATTEMPTED,
    "rounds_formed": events.MM_ROUNDS_FORMED,
    "rounds_aborted": events.MM_ROUNDS_ABORTED,
    "join_failures": events.MM_JOIN_FAILURES,
    "leader_changes": events.MM_LEADER_CHANGES,
    "state_sync_attempts": events.STATE_SYNC_ATTEMPTS,
    "state_sync_retries": events.STATE_SYNC_RETRIES,
    "state_sync_failures": events.STATE_SYNC_FAILURES,
    "checksum_failures": events.STATE_SYNC_CHECKSUM_FAILURES,
    "grads_dropped": events.OPT_GRADS_DROPPED,
    "grads_applied": events.OPT_GRADS_APPLIED,
    "faults_injected": events.FAULTS_APPLIED,
}


def _peer_entry(m, current_step: int) -> Dict:
    t = m.telemetry or {}
    entry: Dict = {
        "peer": m.peer,
        "step": m.step,
        "behind": max(0, current_step - m.step),
        "samples_per_second": m.samples_per_second,
    }
    if m.step_time_ms is not None:
        entry["step_time_ms"] = m.step_time_ms
    for out_key, counter in _PEER_COUNTERS.items():
        entry[out_key] = float(t.get(counter, 0.0))
    form = t.get(events.MM_FORM_GROUP + ".mean")
    if form is not None:
        entry["round_formation_s"] = float(form)
        # the matching sample count lets a streaming consumer (the
        # watchdog) recover the PER-WINDOW mean between two folds from
        # cumulative statistics: mean_w = (c2*m2 - c1*m1) / (c2 - c1)
        count = t.get(events.MM_FORM_GROUP + ".count")
        if count is not None:
            entry["round_formation_count"] = float(count)
    round_dur = t.get(events.AVG_ROUND + ".mean")
    if round_dur is not None:
        entry["round_s"] = float(round_dur)
        count = t.get(events.AVG_ROUND + ".count")
        if count is not None:
            entry["round_count"] = float(count)
    # step-phase flight recorder (telemetry/steps.py): per-phase mean
    # seconds from the snapshot's ``step.phase.<name>.mean`` histogram keys,
    # plus the dominant phase — the coordinator-side half of "why was step N
    # slow now ends in a PHASE". Absent for pre-recorder peers (no keys).
    phases = {}
    phase_counts = {}
    for key, value in t.items():
        if not isinstance(key, str) or not key.startswith("step.phase."):
            continue
        try:
            if key.endswith(".mean"):
                phases[key[len("step.phase."):-len(".mean")]] = float(value)
            elif key.endswith(".count"):
                phase_counts[
                    key[len("step.phase."):-len(".count")]
                ] = float(value)
        except (TypeError, ValueError):
            continue
    if phases:
        entry["phases"] = phases
        entry["dominant_phase"] = max(phases, key=phases.get)
        if phase_counts:
            # per-phase sample counts: the windowing companion to the
            # cumulative means (same rationale as round_count above)
            entry["phase_counts"] = phase_counts
    mfu = t.get(events.STEP_MFU)
    if mfu is not None:
        entry["mfu"] = float(mfu)
    # mean verified checkpoint-fetch goodput this peer measured against its
    # providers — an uplink-bandwidth signal for the twin fitter that
    # exists even on fleets that never ran a single averaging round
    provider_goodput = t.get(events.CKPT_PROVIDER_GOODPUT + ".mean")
    if provider_goodput is not None:
        entry["provider_goodput_bps"] = float(provider_goodput)
    # overlap ledger (collaborative optimizer): cumulative hidden/exposed
    # averaging seconds → lifetime overlap efficiency for this peer
    hidden = float(t.get(events.OPT_OVERLAP_HIDDEN_S, 0.0))
    exposed = float(t.get(events.OPT_OVERLAP_EXPOSED_S, 0.0))
    if hidden or exposed:
        entry["overlap_hidden_s"] = hidden
        entry["overlap_exposed_s"] = exposed
        entry["overlap_efficiency"] = hidden / (hidden + exposed)
    return entry


def _peer_links(tail: Dict) -> Dict[str, Dict[str, float]]:
    """Parse a snapshot's flat ``link.<dst>.<field>`` keys (telemetry/links
    LinkTable.flat) back into per-destination records. Tolerant by
    construction: snapshots that predate link telemetry simply have no
    ``link.`` keys and fold to ``{}`` — the peer keeps its ordinary
    per-peer row, it is never dropped from the fold."""
    links: Dict[str, Dict[str, float]] = {}
    for key, value in tail.items():
        if not isinstance(key, str) or not key.startswith("link."):
            continue
        # rsplit once: field names never contain dots, destinations
        # ("10.0.0.1:31337") routinely do
        dst, _, field = key[len("link."):].rpartition(".")
        if not dst or not field:
            continue
        try:
            links.setdefault(dst, {})[field] = float(value)
        except (TypeError, ValueError):
            continue
    return links


def build_topology(records) -> Optional[Dict]:
    """Fold every peer's per-link estimates into ONE swarm topology record:
    the directed link matrix the hierarchical matchmaker (ROADMAP item 1)
    reads cliques and fat/thin peers from.

    Shape::

        {"peers": {"<label>": "<host:port>" | None, ...},
         "links": [{"src": "<label>", "dst": "<label or host:port>",
                    "dst_endpoint": "<host:port>", "rtt_s": ..,
                    "goodput_bps": .., "bytes": .., ...}, ...]}

    ``dst`` resolves to a peer label when some record advertises that
    endpoint (LocalMetrics.endpoint); otherwise the raw endpoint is kept —
    a link to a peer that never published is still a link. Returns None
    when NO peer reported link telemetry (old-schema swarm): the health
    record then simply has no topology, exactly the pre-link view."""
    peers: Dict[str, Optional[str]] = {}
    by_endpoint: Dict[str, str] = {}
    for m in records:
        endpoint = getattr(m, "endpoint", None)
        peers[m.peer] = endpoint
        if endpoint:
            by_endpoint[endpoint] = m.peer
    links: List[Dict] = []
    for m in records:
        tail = m.telemetry or {}
        for dst, fields in _peer_links(tail).items():
            links.append({
                "src": m.peer,
                "dst": by_endpoint.get(dst, dst),
                "dst_endpoint": dst,
                **fields,
            })
    if not links:
        return None
    return {"peers": peers, "links": links}


def _straggler(peers: List[Dict]) -> Optional[str]:
    """The peer most likely stalling the swarm: deepest behind the current
    step; ties (everyone current) break on the slowest step-phase wall. None
    when nothing distinguishes anyone (healthy swarm).

    behind == 1 is NOT attributed: the coordinator aggregates at the moment
    the FIRST peer's new-step record lands, so a healthy peer whose publish
    or DHT propagation lags by seconds still reads one step behind at that
    tick — naming it would warn on every step advance of a healthy fleet."""
    if not peers:
        return None
    behind = max(peers, key=lambda p: p["behind"])
    if behind["behind"] >= RULE_THRESHOLDS["behind_steps"]:
        return behind["peer"]
    timed = [p for p in peers if p.get("step_time_ms") is not None]
    if len(timed) >= 2:
        slowest = max(timed, key=lambda p: p["step_time_ms"])
        rest = [p["step_time_ms"] for p in timed if p is not slowest]
        # only call out a peer that is clearly off the pack (2x the mean of
        # the others) — a healthy swarm has no straggler
        if slowest["step_time_ms"] > 2.0 * (sum(rest) / len(rest) + 1e-9):
            return slowest["peer"]
    return None


def derive_rates(
    health: Dict,
    prev: Optional[Dict] = None,
    dt_s: Optional[float] = None,
) -> Dict[str, float]:
    """Swarm-level derived rates the rule detectors read — computed from
    ONE swarm-health record's cumulative counters, or WINDOWED between two
    consecutive records when ``prev`` is given (the streaming watchdog's
    case; ``dt_s`` additionally unlocks the per-minute rates).

    Returned keys (each absent when its inputs are, never guessed):
    ``round_abort_rate``, ``join_failure_rate``, ``conns_lost`` (count over
    the window / lifetime), ``conns_lost_per_min`` (needs ``dt_s``),
    ``peer_loss_ratio`` (the worst peer's conns-lost per RPC call) and
    ``peer_loss_ratio_peer`` (who that is)."""

    def total(record: Optional[Dict], key: str) -> float:
        if not record:
            return 0.0
        return sum(
            float(p.get(key, 0.0)) for p in record.get("peers", [])
            if isinstance(p, dict)
        )

    def window(key: str) -> float:
        # clamped at 0: a peer set that shrank (churn) can make the
        # cumulative swarm sum regress without anything "un-happening"
        return max(0.0, total(health, key) - total(prev, key))

    rates: Dict[str, float] = {}
    attempted = window("rounds_attempted")
    aborted = window("rounds_aborted")
    if attempted > 0:
        rates["round_abort_rate"] = round(aborted / attempted, 4)
    formed = window("rounds_formed")
    if attempted > 0:
        # attempts that never produced a group (clamped: formed can lag
        # attempted by in-flight rounds at the fold boundary)
        rates["join_failure_rate"] = round(
            max(0.0, attempted - formed) / attempted, 4
        )
        # informational contention gauge, no rule attached: internal
        # leader-race retries per attempt — high on any contended flat
        # swarm, interesting for sizing, not an incident
        rates["join_retries_per_attempt"] = round(
            window("join_failures") / attempted, 2
        )
    conns_lost = window("conns_lost")
    rates["conns_lost"] = round(conns_lost, 1)
    if dt_s is not None and dt_s > 0:
        rates["conns_lost_per_min"] = round(conns_lost / (dt_s / 60.0), 3)
    worst_ratio, worst_peer = 0.0, None
    for p in health.get("peers", []):
        if not isinstance(p, dict):
            continue
        calls = float(p.get("rpc_calls", 0.0))
        lost = float(p.get("conns_lost", 0.0))
        # ratios stay cumulative even in windowed mode: per-peer windows
        # need the prev record's matching peer row, and a lifetime ratio
        # is the conservative (non-flapping) reading for a rule threshold
        if calls >= 20 and lost / calls > worst_ratio:
            worst_ratio, worst_peer = lost / calls, p.get("peer")
    if worst_peer is not None and worst_ratio > 0:
        rates["peer_loss_ratio"] = round(worst_ratio, 4)
        rates["peer_loss_ratio_peer"] = worst_peer
    return rates


def verdict_from_rates(
    rates: Dict[str, Any], straggler: Optional[str] = None
) -> Tuple[str, str]:
    """("OK"|"DEGRADED", reason) from a derived-rates dict — THE shared
    rule evaluation: ``runlog_summary --health``'s header, the coordinator
    fold and the watchdog all call this with RULE_THRESHOLDS applied to
    whatever rates their input could support."""
    reasons: List[str] = []
    for key in ("round_abort_rate", "join_failure_rate",
                "conns_lost_per_min", "peer_loss_ratio"):
        value = rates.get(key)
        if value is None:
            continue
        limit = RULE_THRESHOLDS[key]
        if float(value) > limit:
            tag = f"{key} {float(value):.3g} > {limit:g}"
            if key == "peer_loss_ratio" and rates.get(
                "peer_loss_ratio_peer"
            ):
                tag += f" ({rates['peer_loss_ratio_peer']})"
            reasons.append(tag)
    if straggler:
        reasons.append(f"straggler {straggler}")
    if reasons:
        return "DEGRADED", "; ".join(reasons)
    return "OK", "all rule rates within thresholds"


def build_swarm_health(records, rounds: Optional[List[Dict]] = None,
                       prev: Optional[Dict] = None,
                       dt_s: Optional[float] = None) -> Optional[Dict]:
    """Fold fetched per-peer ``LocalMetrics`` (collaborative/metrics.py)
    into one swarm-health record. Returns None when there are no records;
    peers without a telemetry tail still contribute step/throughput rows.

    ``rounds`` (optional) attaches recent round summaries
    (``[{"round_id", "peer", "dur_s", "ok", "trace"?}, ...]``) when the
    folder has them — the simulator's coordinator fold does; the production
    metrics bus carries only flat floats, so a live coordinator's records
    simply lack the field and the watchdog reports that in its coverage.
    ``prev``/``dt_s`` window the derived rates against the previous fold."""
    if not records:
        return None
    current_step = max(m.step for m in records)
    peers = [_peer_entry(m, current_step) for m in records]
    attempts = sum(p["state_sync_attempts"] for p in peers)
    retries = sum(p["state_sync_retries"] for p in peers)
    formation = [
        p["round_formation_s"] for p in peers if "round_formation_s" in p
    ]
    health: Dict = {
        "current_step": current_step,
        "peers": peers,
        "straggler": _straggler(peers),
        "retry_rate": (retries / attempts) if attempts else 0.0,
        "faults_injected": sum(p["faults_injected"] for p in peers),
    }
    if formation:
        health["round_formation_s"] = sum(formation) / len(formation)
    if rounds:
        health["rounds"] = rounds
    # swarm topology (per-link telemetry): absent — not an error — when no
    # peer reports link estimates (telemetry off, or a pre-link fleet)
    topology = build_topology(records)
    if topology is not None:
        health["topology"] = topology
    # swarm-level derived rates + the one-line verdict, from the SAME rule
    # set the watchdog runs (RULE_THRESHOLDS) — the fold and the live view
    # cannot disagree
    rates = derive_rates(health, prev=prev, dt_s=dt_s)
    health["derived"] = rates
    status, reason = verdict_from_rates(rates, health["straggler"])
    health["verdict"] = {"status": status, "reason": reason}
    return health
