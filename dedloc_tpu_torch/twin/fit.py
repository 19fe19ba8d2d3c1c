"""Fit the simulator's network/compute model from a real run's telemetry.

The repo has two halves that never talked (ROADMAP item 4): production
telemetry — per-link RTT/goodput EWMAs (PR 6), step phases and the overlap
ledger (PR 8), matchmaking/round spans (PR 2) — and a deterministic
discrete-event simulator with latency/bandwidth/loss models (PR 7). This
module is the bridge: it reads a run's per-peer event logs (the
``--telemetry.event_log_path`` JSONL) or a coordinator metrics JSONL whose
``swarm_health`` records already folded the per-peer snapshots, and fits a
serializable **TwinModel**: per-directed-link latency/jitter/bandwidth/loss,
per-peer compute, and the recorded workload shape (round cadence, group
size, span/chunk bytes, boundaries, restores).

Fitting rules — each one exists to keep the twin honest:

- **Latency/jitter** come from ``link.*`` RTT stats (the free SYN/SYN-ACK
  probe): one-way latency is half the base RTT — the MINIMUM sample when
  recorded, since every connect timing carries event-loop scheduling noise
  a replay would otherwise pay twice — and jitter is half the RTT
  deviation EWMA. Links that carried traffic but never got an RTT sample
  (the per-peer ``link.stats`` emission is top-K bounded) inherit the
  measured median, never the global constant.
- **Bandwidth is fitted as the sender's serialized UPLINK rate**, which is
  what the simulator's ``LinkSpec.bandwidth_bps`` actually models. Per-flow
  telemetry (goodput EWMAs, per-chunk rates) is measured while the sender's
  uplink is shared across all of a round's partners — installing it
  verbatim would make the replay charge the contention twice. The primary
  estimator is per-round wire volume over the latency-corrected round wall
  (``allreduce.link`` bytes × 2 for the gather replies ÷ the ``avg.round``
  span minus the request/ack chain), taken at each sender's LEAST-blocked
  round, and lower-bounded by the best latency-corrected per-flow rate;
  fallbacks (goodput/peak/wire aggregates, scaled by the recorded
  concurrency) are noted in the coverage summary.
- **Loss** is connection deaths over transfers (``rpc.conn_lost`` events
  per endpoint; per-peer ``conns_lost``/``rpc_calls`` from a swarm-health
  fold), clamped to the simulator's meaningful range.
- **Compute** is the ``step.phase.fwd_bwd`` mean per peer (event logs:
  ``step.record`` phases; coordinator JSONL: the folded ``phases`` map).
- **Nothing is fitted silently.** Every dimension that degrades to a
  default lands in ``coverage`` — the fit of a jammed, truncated or
  pre-link-schema log *reports* its blind spots instead of hiding them.

The model is deliberately JSON-flat (``TwinModel.to_dict``): it is an
artifact operators diff, archive next to checkpoints, and feed to
``tools/twin_sweep.py`` or the ``twin_replay`` scenario.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from dedloc_tpu_torch.simulator.network import LinkSpec
# the catalog module is aliased: this file's row lists are named ``events``
from dedloc_tpu_torch.telemetry import events as ev
from dedloc_tpu_torch.utils.logging import get_logger

# the SAME nearest-rank percentile the simulator's reports use
# (utils/stats.py): observed and predicted statistics are like-for-like
# by construction, not because two copies stayed in sync
from dedloc_tpu_torch.utils.stats import median as _median
from dedloc_tpu_torch.utils.stats import percentile

logger = get_logger(__name__)

SCHEMA_VERSION = 1

# fleet-shaped fallbacks for unmeasured dimensions (the docs/simulator.md
# volunteer-link default): 20 ms one-way, ~100 Mbit/s uplink, no loss.
DEFAULT_LINK = {
    "latency_s": 0.02,
    "bandwidth_bps": 12_500_000.0,
    "loss": 0.0,
    "jitter_s": 0.0,
}
DEFAULT_COMPUTE_S = 0.1
DEFAULT_SAMPLES_PER_BOUNDARY = 16

LINK_KEY_SEP = "|"  # "src|dst" in the serialized link table


def safe_label(raw) -> str:
    """Peer labels are fleet-controlled input, and the serialized link
    table keys on ``src|dst`` — a label carrying the separator would make
    those keys ambiguous (and crash the key round trip). Sanitized once at
    ingestion; the fit must degrade, never crash, on hostile input."""
    return str(raw).replace(LINK_KEY_SEP, "_")




@dataclass
class TwinModel:
    """A fitted digital twin: everything ``twin/replay.py`` needs to
    re-instantiate the swarm in the simulator, plus the OBSERVED metrics
    the replay's predictions are judged against (the fidelity report) and
    the fit-coverage summary that says which numbers are measurements and
    which are defaults."""

    peers: Dict[str, Dict[str, float]] = field(default_factory=dict)
    links: Dict[str, Dict[str, float]] = field(default_factory=dict)
    default_link: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_LINK)
    )
    workload: Dict[str, Any] = field(default_factory=dict)
    observed: Dict[str, Any] = field(default_factory=dict)
    coverage: Dict[str, Any] = field(default_factory=dict)
    schema: int = SCHEMA_VERSION

    # ------------------------------------------------------- serialization

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": self.schema,
            "peers": self.peers,
            "links": self.links,
            "default_link": self.default_link,
            "workload": self.workload,
            "observed": self.observed,
            "coverage": self.coverage,
        }

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "TwinModel":
        if not isinstance(raw, dict) or "peers" not in raw:
            raise ValueError("not a TwinModel dict (no 'peers')")
        schema = int(raw.get("schema", SCHEMA_VERSION))
        if schema > SCHEMA_VERSION:
            logger.warning(
                f"TwinModel schema {schema} is newer than this build "
                f"({SCHEMA_VERSION}); reading what is understood"
            )
        return cls(
            peers=dict(raw.get("peers", {})),
            links=dict(raw.get("links", {})),
            default_link={**DEFAULT_LINK, **(raw.get("default_link") or {})},
            workload=dict(raw.get("workload", {})),
            observed=dict(raw.get("observed", {})),
            coverage=dict(raw.get("coverage", {})),
            schema=schema,
        )

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TwinModel":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    # ------------------------------------------------------------- helpers

    def link_spec(self, src: str, dst: str) -> LinkSpec:
        raw = self.links.get(f"{src}{LINK_KEY_SEP}{dst}")
        if raw is None:
            return LinkSpec.from_dict(self.default_link)
        return LinkSpec.from_dict({**self.default_link, **raw})

    def describe(self) -> List[str]:
        """Human summary lines (the --twin header)."""
        cov = self.coverage
        out = [
            f"twin: {len(self.peers)} peer(s), "
            f"{len(self.links)} fitted directed link(s)",
            f"fit coverage: {cov.get('links_with_rtt', 0)} link(s) with "
            f"RTT, {cov.get('links_with_bandwidth', 0)} with bandwidth "
            f"({cov.get('links_with_uplink_estimate', 0)} from per-round "
            "uplink volume), "
            f"{cov.get('peers_with_compute', 0)}/"
            f"{len(self.peers)} peer(s) with measured compute",
        ]
        for warning in cov.get("warnings", []):
            out.append(f"coverage warning: {warning}")
        return out


class _LinkFit:
    """Accumulates every signal observed for one directed link."""

    __slots__ = (
        "rtt_s", "rtt_min_s", "rtt_jitter_s", "goodput_bps", "peak_bps",
        "transfers", "wire_bytes", "wire_send_s", "wire_chunks",
        "round_bytes", "conn_lost",
    )

    def __init__(self) -> None:
        self.rtt_s: Optional[float] = None
        self.rtt_min_s: Optional[float] = None
        self.rtt_jitter_s: Optional[float] = None
        self.goodput_bps: Optional[float] = None
        self.peak_bps: Optional[float] = None
        self.transfers = 0.0
        self.wire_bytes = 0.0
        self.wire_send_s = 0.0
        self.wire_chunks = 0.0
        self.round_bytes: List[float] = []
        self.conn_lost = 0.0


def _resolve_label(dst: str, labels: set, endpoint_map: Dict[str, str]):
    """Resolve a link destination ("host:port") to a peer label via
    endpoint self-identification events / the folded topology map, falling
    back to the host part when it IS a known label (simulator logs name
    hosts after peers)."""
    if dst in endpoint_map:
        return endpoint_map[dst]
    host = safe_label(dst.rsplit(":", 1)[0])
    if host in labels:
        return host
    return None


def fit_twin(rows: List[Dict[str, Any]],
             defaults: Optional[Dict[str, float]] = None) -> TwinModel:
    """Fit a TwinModel from loaded JSONL rows (event logs and/or a
    coordinator metrics JSONL — pass everything through the shared
    ``load_jsonl_rows`` loader first; it already survives jammed and
    truncated files).

    Raises ``ValueError`` only when NO peer is identifiable at all;
    anything less degrades to defaults with the gap named in
    ``coverage``."""
    defaults = {**DEFAULT_LINK, **(defaults or {})}
    events = [
        r for r in rows
        if isinstance(r, dict) and isinstance(r.get("event"), str)
    ]
    # sanitize peer labels at the door (see safe_label); shallow-copy only
    # the rare offending rows so callers' lists stay untouched
    events = [
        {**r, "peer": safe_label(r["peer"])}
        if LINK_KEY_SEP in str(r.get("peer", "")) else r
        for r in events
    ]
    health_rows = [
        r for r in rows
        if isinstance(r, dict) and isinstance(r.get("swarm_health"), dict)
    ]
    healths = [r["swarm_health"] for r in health_rows]
    warnings: List[str] = []

    # a coordinator JSONL whose folds carry recent-round summaries (the
    # in-process/simulator fold does; the flat production metrics bus
    # cannot) fits round walls and workload shape from the coordinator's
    # own log — the watchdog's self-retune path. Adopted as avg.round rows
    # ONLY when no per-peer event log contributed real ones, so feeding
    # both never double-counts a round.
    rounds_from_folds = 0
    if not any(r.get("event") == ev.AVG_ROUND for r in events):
        for row in health_rows:
            fold_t = row.get("time")
            for rd in row["swarm_health"].get("rounds") or []:
                if not isinstance(rd, dict) or rd.get("dur_s") is None:
                    continue
                synthetic = {
                    "event": ev.AVG_ROUND,
                    "peer": safe_label(rd.get("peer", "?")),
                    "round_id": rd.get("round_id"),
                    "dur_s": float(rd["dur_s"]),
                    "ok": rd.get("ok", True),
                    # the fold stamps its time at the round's tail — the
                    # same span-exit convention real avg.round events use
                    "t": float(fold_t) if fold_t is not None else 0.0,
                }
                if rd.get("group_size") is not None:
                    synthetic["group_size"] = rd["group_size"]
                events.append(synthetic)
                rounds_from_folds += 1

    # ---------------------------------------------------------- peer roster
    labels = {
        str(r["peer"]) for r in events if r.get("peer")
    }
    for health in healths:
        for p in health.get("peers", []):
            if isinstance(p, dict) and p.get("peer"):
                labels.add(safe_label(p["peer"]))
    if not labels:
        raise ValueError(
            "no peers identifiable in the given rows — need per-peer event "
            "logs (with 'peer' fields) or a coordinator JSONL with "
            "swarm_health records"
        )

    endpoint_map: Dict[str, str] = {}
    for r in events:
        if r.get("event") == ev.PEER_ENDPOINT and r.get("endpoint"):
            endpoint_map[str(r["endpoint"])] = safe_label(r.get("peer", "?"))
    for health in healths:
        topo = health.get("topology") or {}
        for label, endpoint in (topo.get("peers") or {}).items():
            if endpoint:
                endpoint_map.setdefault(str(endpoint), safe_label(label))

    # ------------------------------------------------------------ link fits
    fits: Dict[Tuple[str, str], _LinkFit] = {}

    def fit_for(src: str, dst_label: str) -> _LinkFit:
        return fits.setdefault((src, dst_label), _LinkFit())

    unresolved_dsts = 0
    # newest link.stats per (peer, dst) wins: they are cumulative estimates
    latest_stats: Dict[Tuple[str, str], Dict[str, Any]] = {}
    # per (src, round_id): scatter bytes/chunks/fan-out this member pushed
    # — the uplink estimator's inputs
    sent_by_src_round: Dict[Tuple[str, str], Dict[str, float]] = {}
    for r in events:
        name = r.get("event")
        src = str(r.get("peer", "?"))
        if name == ev.LINK_STATS and r.get("dst"):
            latest_stats[(src, str(r["dst"]))] = r
        elif name == ev.ALLREDUCE_LINK and r.get("dst"):
            dst_label = _resolve_label(str(r["dst"]), labels, endpoint_map)
            if dst_label is None:
                unresolved_dsts += 1
                continue
            f = fit_for(src, dst_label)
            sent = float(r.get("sent_bytes", 0.0))
            f.wire_bytes += sent
            f.wire_send_s += float(r.get("send_s", 0.0))
            f.wire_chunks += float(r.get("chunks_sent", 0.0))
            if sent > 0:
                f.round_bytes.append(sent)
                if r.get("round_id"):
                    key = (src, str(r["round_id"]))
                    acc = sent_by_src_round.setdefault(
                        key, {"sent": 0.0, "chunks": 0.0, "dsts": 0.0}
                    )
                    acc["sent"] += sent
                    acc["chunks"] += float(r.get("chunks_sent", 0.0))
                    acc["dsts"] += 1.0
        elif name == ev.RPC_CONN_LOST and r.get("endpoint"):
            dst_label = _resolve_label(
                str(r["endpoint"]), labels, endpoint_map
            )
            if dst_label is not None:
                fit_for(src, dst_label).conn_lost += 1.0
    for (src, dst), r in latest_stats.items():
        dst_label = _resolve_label(dst, labels, endpoint_map)
        if dst_label is None:
            unresolved_dsts += 1
            continue
        f = fit_for(src, dst_label)
        if r.get("rtt_s") is not None:
            f.rtt_s = float(r["rtt_s"])
        if r.get("rtt_min_s") is not None:
            f.rtt_min_s = float(r["rtt_min_s"])
        if r.get("rtt_jitter_s") is not None:
            f.rtt_jitter_s = float(r["rtt_jitter_s"])
        if r.get("goodput_bps") is not None:
            f.goodput_bps = float(r["goodput_bps"])
        if r.get("peak_bps") is not None:
            f.peak_bps = float(r["peak_bps"])
        f.transfers = max(f.transfers, float(r.get("transfers", 0.0)))
    # coordinator fold: the newest topology record's links
    for health in healths:
        topo = health.get("topology") or {}
        for link in topo.get("links", []):
            if not isinstance(link, dict):
                continue
            src = safe_label(link.get("src", "?"))
            dst_label = _resolve_label(
                str(link.get("dst_endpoint", link.get("dst", ""))),
                labels, endpoint_map,
            ) or (
                safe_label(link["dst"])
                if safe_label(link.get("dst")) in labels else None
            )
            if dst_label is None:
                unresolved_dsts += 1
                continue
            f = fit_for(src, dst_label)
            if link.get("rtt_s") is not None:
                f.rtt_s = float(link["rtt_s"])
            if link.get("rtt_min_s") is not None:
                f.rtt_min_s = float(link["rtt_min_s"])
            if link.get("rtt_jitter_s") is not None:
                f.rtt_jitter_s = float(link["rtt_jitter_s"])
            if link.get("goodput_bps") is not None:
                f.goodput_bps = float(link["goodput_bps"])
            if link.get("peak_bps") is not None:
                f.peak_bps = float(link["peak_bps"])
            f.transfers = max(f.transfers, float(link.get("transfers", 0.0)))
    if unresolved_dsts:
        warnings.append(
            f"{unresolved_dsts} link record(s) pointed at endpoints no "
            "peer label resolves — those links were skipped"
        )

    # per-peer loss fallback (coordinator fold: conns_lost / rpc_calls)
    peer_loss: Dict[str, float] = {}
    for health in healths:
        for p in health.get("peers", []):
            if not isinstance(p, dict):
                continue
            calls = float(p.get("rpc_calls", 0.0))
            lost = float(p.get("conns_lost", 0.0))
            if calls > 0 and lost > 0:
                peer_loss[safe_label(p.get("peer", "?"))] = min(
                    0.5, lost / calls
                )

    # ---------------------------------------------------- rounds (early:
    # the uplink estimator needs per-member round walls)
    rounds_by_id: Dict[str, List[Dict[str, Any]]] = {}
    round_dur: Dict[Tuple[str, str], float] = {}
    for r in events:
        if r.get("event") == ev.AVG_ROUND and r.get("round_id"):
            rid = str(r["round_id"])
            rounds_by_id.setdefault(rid, []).append(r)
            if r.get("dur_s") is not None and r.get("ok") is not False:
                round_dur[(str(r.get("peer", "?")), rid)] = float(
                    r["dur_s"]
                )
    group_sizes = [
        float(r["group_size"])
        for rs in rounds_by_id.values() for r in rs
        if r.get("group_size") is not None
    ]
    # a member's round pushes its scatter bytes plus (serving the gather's
    # reduced chunks to its partners) roughly the same volume again through
    # its uplink, all inside its round wall — per-round volume over wall is
    # the serialized-uplink rate the simulator's bandwidth model wants,
    # already free of the per-flow contention that biases goodput EWMAs.
    # The BEST round per source wins: a fast peer grouped with a straggler
    # spends its wall WAITING, not transmitting, so its blocked rounds
    # read far below its real uplink — the least-blocked round is the
    # honest sample (and for a peer that is itself the bottleneck, every
    # round reads the same, so the max changes nothing).
    # base RTT per link/source: prefer the MINIMUM connect sample — the
    # EWMA carries the caller's event-loop scheduling noise, which a
    # replay would then pay a second time on top of its own
    def base_rtt(f: _LinkFit) -> Optional[float]:
        return f.rtt_min_s if f.rtt_min_s is not None else f.rtt_s

    rtt_by_src: Dict[str, float] = {}
    for src in {s for (s, _d) in fits}:
        rtts = [
            base_rtt(f) for (s, _d), f in fits.items()
            if s == src and base_rtt(f) is not None
        ]
        if rtts:
            rtt_by_src[src] = _median(rtts)
    uplink_samples: Dict[str, List[float]] = {}
    for (src, rid), acc in sent_by_src_round.items():
        dur = round_dur.get((src, rid))
        if not dur or dur <= 0 or acc["dsts"] <= 0:
            continue
        # the request/ack round trips EXPOSED in the member's wall: each
        # destination's chunk chain is sequential, but with D destinations
        # in flight the uplink keeps transmitting other chunks while one
        # chain waits on its ack — so of the chunks/D per-destination
        # round trips, only ~1/D of each is actually exposed wall
        # (chunks/D² total), plus one tail round trip. That is LATENCY,
        # already fitted separately; leaving it in the denominator would
        # bill it a second time as low bandwidth on replay.
        rtt_chain = (
            (acc["chunks"] / (acc["dsts"] ** 2) + 1.0)
            * rtt_by_src.get(src, 0.0)
        )
        transmit = max(dur - rtt_chain, dur * 0.2)
        uplink_samples.setdefault(src, []).append(
            2.0 * acc["sent"] / transmit
        )
    uplink_bps: Dict[str, float] = {
        src: max(samples) for src, samples in uplink_samples.items()
    }
    # per-flow lower bounds: a fast peer that spent every recorded round
    # grouped with a straggler never shows its uplink in round volume
    # (its wall is wait, not transmission). Two rescues, both taken as a
    # MAX (an uplink is at least as fast as any flow it carried):
    # - the best single-transfer peak;
    # - the latency-CORRECTED wire rate: per-chunk timings include a full
    #   request/ack round trip, so on a fast link the RTT — not the
    #   bandwidth — dominates every sample and raw rates saturate around
    #   chunk_bytes/rtt. Subtracting the known per-chunk RTT cost recovers
    #   the transmit time. The subtraction is ill-conditioned exactly when
    #   latency dominates — which is when the resulting (possibly huge)
    #   estimate is also harmless, because the replayed wall is set by the
    #   latency either way; when queueing dominates (a genuinely thin
    #   uplink) the correction is negligible and the volume estimate wins.
    for (src, dst_label), f in fits.items():
        if src not in uplink_bps:
            continue
        floor = f.peak_bps or 0.0
        rtt0 = base_rtt(f)
        if f.wire_bytes > 0 and f.wire_send_s > 0 and rtt0 is not None:
            # floor at 20% of the raw wall: the correction is only exact
            # for uncontended flows (where it can win the max); on
            # contended flows the round trips overlapped the queueing and
            # a full subtraction would manufacture bandwidth
            adjusted = max(
                f.wire_send_s - f.wire_chunks * rtt0,
                f.wire_send_s * 0.2,
            )
            floor = max(floor, f.wire_bytes / adjusted)
        # the floor is a RESCUE, not a refinement: the structural volume
        # estimate wins unless per-flow evidence contradicts it decisively
        # (a peer whose every recorded round was blocked behind a
        # straggler reads catastrophically low on volume — 2x is well
        # past any per-flow estimator's own bias)
        if floor > 2.0 * uplink_bps[src]:
            uplink_bps[src] = floor
    # per-flow fallbacks are contended across the round's partners: scale
    # them back up by the recorded concurrency
    concurrency = max(1.0, _median(group_sizes, 2.0) - 1.0)

    links: Dict[str, Dict[str, float]] = {}
    links_with_rtt = links_with_bw = links_with_uplink = 0
    links_with_loss = links_from_wire = 0
    for (src, dst_label), f in sorted(fits.items()):
        bandwidth: Optional[float] = None
        if src in uplink_bps:
            bandwidth = uplink_bps[src]
            links_with_uplink += 1
        elif f.peak_bps is not None:
            bandwidth = f.peak_bps * concurrency
        elif f.goodput_bps is not None:
            bandwidth = f.goodput_bps * concurrency
        elif f.wire_bytes > 0 and f.wire_send_s > 0:
            bandwidth = (f.wire_bytes / f.wire_send_s) * concurrency
            links_from_wire += 1
        loss: Optional[float] = None
        transfers = max(f.transfers, f.wire_chunks)
        if f.conn_lost > 0 and transfers > 0:
            loss = min(0.5, f.conn_lost / transfers)
            links_with_loss += 1
        elif src in peer_loss:
            loss = peer_loss[src]
        spec = LinkSpec.from_estimate(
            rtt_s=base_rtt(f),
            rtt_jitter_s=f.rtt_jitter_s,  # from_estimate halves RTT terms
            goodput_bps=bandwidth,
            loss=loss,
            default=LinkSpec.from_dict(defaults),
        )
        if f.rtt_s is not None:
            links_with_rtt += 1
        if bandwidth is not None:
            links_with_bw += 1
        entry: Dict[str, float] = {
            "latency_s": round(spec.latency_s, 6),
            "jitter_s": round(spec.jitter_s, 6),
            "bandwidth_bps": round(spec.bandwidth_bps, 1),
            "loss": round(spec.loss, 5),
        }
        links[f"{src}{LINK_KEY_SEP}{dst_label}"] = entry
    # links that carried wire traffic but never got an RTT sample (the
    # per-peer link.stats emission is top-K bounded on real fleets)
    # inherit the MEASURED median latency/jitter, not the global constant
    # — same swarm-is-its-own-prior rule as the default link below
    measured_lat = [
        links[key]["latency_s"] for key in links
        if base_rtt(fits[tuple(key.split(LINK_KEY_SEP, 1))]) is not None
    ]
    links_rtt_backfilled = 0
    if measured_lat:
        med_lat = _median(measured_lat)
        med_jit = _median([
            links[key]["jitter_s"] for key in links
            if base_rtt(fits[tuple(key.split(LINK_KEY_SEP, 1))]) is not None
        ])
        for key, entry in links.items():
            if base_rtt(fits[tuple(key.split(LINK_KEY_SEP, 1))]) is None:
                entry["latency_s"] = med_lat
                entry["jitter_s"] = med_jit
                links_rtt_backfilled += 1
    if links:
        # pairs never observed together (they simply never shared a round)
        # replay as the TYPICAL fitted link, not as the global constant —
        # the swarm's own distribution is the best prior for its own
        # unobserved pairs
        defaults = {
            "latency_s": _median(
                [spec["latency_s"] for spec in links.values()]
            ),
            "jitter_s": _median(
                [spec["jitter_s"] for spec in links.values()]
            ),
            "bandwidth_bps": _median(
                [spec["bandwidth_bps"] for spec in links.values()]
            ),
            "loss": _median([spec["loss"] for spec in links.values()]),
        }
    else:
        warnings.append(
            "no link telemetry at all (pre-link-schema peers, or telemetry "
            "was off): every link replays with the default spec"
        )

    # ------------------------------------------------------- per-peer fits
    step_records: Dict[str, List[Dict[str, Any]]] = {}
    for r in events:
        if r.get("event") == ev.STEP_RECORD:
            step_records.setdefault(str(r.get("peer", "?")), []).append(r)
    health_phases: Dict[str, Dict[str, float]] = {}
    for health in healths:  # newest record wins per peer
        for p in health.get("peers", []):
            if isinstance(p, dict) and isinstance(p.get("phases"), dict):
                health_phases[safe_label(p.get("peer", "?"))] = p["phases"]

    peers: Dict[str, Dict[str, float]] = {}
    peers_with_compute = 0
    for label in sorted(labels):
        compute: Optional[float] = None
        samples = DEFAULT_SAMPLES_PER_BOUNDARY
        records = step_records.get(label, [])
        fwd = [
            float(r["phases"]["fwd_bwd"]) for r in records
            if isinstance(r.get("phases"), dict)
            and r["phases"].get("fwd_bwd") is not None
        ]
        if fwd:
            compute = sum(fwd) / len(fwd)
        elif label in health_phases and (
            health_phases[label].get("fwd_bwd") is not None
        ):
            compute = float(health_phases[label]["fwd_bwd"])
        sample_values = [
            float(r["samples"]) for r in records
            if r.get("samples") is not None
        ]
        if sample_values:
            samples = int(_median(sample_values))
        if compute is not None:
            peers_with_compute += 1
        outgoing = [
            spec["bandwidth_bps"]
            for key, spec in links.items()
            if key.split(LINK_KEY_SEP, 1)[0] == label
        ]
        entry: Dict[str, float] = {
            "compute_s": round(
                compute if compute is not None else DEFAULT_COMPUTE_S, 6
            ),
            "samples_per_boundary": samples,
        }
        if outgoing:
            entry["uplink_bps"] = round(max(outgoing), 1)
        peers[label] = entry
    if peers_with_compute == 0:
        warnings.append(
            "no step-phase telemetry (pre-recorder peers?): per-peer "
            f"compute defaults to {DEFAULT_COMPUTE_S}s per boundary"
        )

    # --------------------------------------------------- workload + observed
    # round-wall percentiles over every MEMBER's span of every round —
    # the same statistic the replay report computes, and far more stable
    # than per-round maxima on short recordings
    round_walls = [
        float(r["dur_s"])
        for rs in rounds_by_id.values() for r in rs
        if r.get("dur_s") is not None and r.get("ok") is not False
    ]
    formation = [
        float(r["dur_s"]) for r in events
        if r.get("event") == ev.MM_FORM_GROUP
        and r.get("dur_s") is not None and r.get("ok") is not False
    ]
    span_bytes = _median(
        [b for f in fits.values() for b in f.round_bytes], 0.0
    )
    chunk_candidates = [
        f.wire_bytes / f.wire_chunks
        for f in fits.values() if f.wire_chunks > 0
    ]
    boundaries = 0.0
    if rounds_by_id and step_records:
        n_rounds = len(rounds_by_id)
        boundaries = _median(
            [len(records) / n_rounds for records in step_records.values()],
            0.0,
        )
    ledgers = [
        r for r in events if r.get("event") == ev.OPT_OVERLAP_LEDGER
    ]
    hidden = sum(float(r.get("hidden_s", 0.0)) for r in ledgers)
    exposed = sum(float(r.get("exposed_s", 0.0)) for r in ledgers)
    restores = [
        r for r in events
        if r.get("event") == ev.CKPT_RESTORE and r.get("ok")
    ]
    # round cadence: gaps between successive round STARTS (event t stamps
    # are span exits; subtract the duration)
    starts = sorted(
        min(
            float(r.get("t", 0.0)) - float(r.get("dur_s", 0.0))
            for r in rs
        )
        for rs in rounds_by_id.values()
    )
    gaps = [b - a for a, b in zip(starts, starts[1:]) if b > a]

    workload: Dict[str, Any] = {
        "rounds": len(rounds_by_id),
        "group_size": int(_median(group_sizes, 0.0)) or None,
        "span_bytes": int(span_bytes) or None,
        "chunk_bytes": int(_median(chunk_candidates, 0.0)) or None,
        "boundaries": int(round(boundaries)) or None,
        "round_cadence_s": round(_median(gaps, 0.0), 4) or None,
        "overlap": any(r.get("mode") == "overlap" for r in ledgers),
        "restores": len(restores),
    }
    # a recorded run config (the driver's run.config event; a real fleet's
    # logged flags) beats inference — config is KNOWN, only physics needs
    # fitting. The newest record wins; estimator values above fill gaps.
    config_events = [r for r in events if r.get("event") == ev.RUN_CONFIG]
    config_fields = 0
    if config_events:
        newest = config_events[-1]
        for key in ("window_s", "group_size", "span_bytes", "chunk_bytes",
                    "boundaries", "samples_per_boundary", "overlap",
                    "compression"):
            if newest.get(key) is not None:
                workload[key] = newest[key]
                config_fields += 1
    if rounds_by_id and "compression" not in workload:
        # the wire-byte observations already bake in whatever codec the
        # run used; a sweep's compression axis is RELATIVE to that level,
        # so not knowing it makes that one axis untrustworthy — say so
        warnings.append(
            "recorded wire-compression level unknown (no run.config "
            "'compression' field): the replay treats recorded bytes as "
            "uncompressed, so sweep predictions across compression "
            "levels are relative to the run's actual level, not to none"
        )
    if restores:
        workload["restore_bytes"] = int(_median(
            [float(r.get("bytes", 0.0)) for r in restores], 0.0
        ))
        workload["restore_providers"] = int(_median(
            [float(r.get("providers", 1.0)) for r in restores], 1.0
        ))
    if workload.get("window_s") is None and workload["round_cadence_s"]:
        # no recorded config: recover the matchmaking window from the
        # cadence: cadence ≈ compute + formation + round wall + (window+1)
        # idle (the workload driver's round spacing). Weakly identified —
        # prefer logs that carry run.config.
        compute_med = _median(
            [p["compute_s"] for p in peers.values()], DEFAULT_COMPUTE_S
        )
        # the cadence is measured between the EARLIEST member's round
        # starts, so the formation term on its critical path is the fast
        # tail of the formation distribution, not its median
        est = (
            workload["round_cadence_s"]
            - percentile(formation, 0.25)
            - percentile(round_walls, 0.50)
            - compute_med * (workload["boundaries"] or 1)
            - 1.0
        )
        workload["window_s"] = round(max(1.0, est), 2)
    if not rounds_by_id:
        warnings.append(
            "no avg.round spans: workload shape is unknown — replay needs "
            "explicit overrides (rounds/group_size/span_bytes)"
        )

    per_peer_wall: Dict[str, List[float]] = {}
    for rs in rounds_by_id.values():
        for r in rs:
            if r.get("dur_s") is not None and r.get("ok") is not False:
                per_peer_wall.setdefault(
                    str(r.get("peer", "?")), []
                ).append(float(r["dur_s"]))
    step_ts = [
        float(r.get("t", 0.0))
        for records in step_records.values() for r in records
    ]
    total_samples = sum(
        float(r.get("samples", 0.0))
        for records in step_records.values() for r in records
    )
    samples_per_sec = None
    if len(step_ts) >= 2 and max(step_ts) > min(step_ts):
        samples_per_sec = round(
            total_samples / (max(step_ts) - min(step_ts)), 3
        )
    def _pct(values: List[float], q: float) -> Optional[float]:
        # None, not 0.0: an unmeasured metric must stay distinguishable
        # from an instant one in the archived model and fidelity table
        return round(percentile(values, q), 4) if values else None

    observed: Dict[str, Any] = {
        "round_wall_p50_s": _pct(round_walls, 0.50),
        "round_wall_p95_s": _pct(round_walls, 0.95),
        "formation_p50_s": _pct(formation, 0.50),
        "formation_p95_s": _pct(formation, 0.95),
        "samples_per_sec": samples_per_sec,
        "overlap_efficiency": (
            round(hidden / (hidden + exposed), 4)
            if (hidden + exposed) > 0 else None
        ),
        "per_peer_round_wall_s": {
            label: round(sum(walls) / len(walls), 4)
            for label, walls in sorted(per_peer_wall.items())
        },
    }
    # worst-first directed links by their OBSERVED contended send rate
    # (wire bytes over send wall — the same observable the replay's report
    # ranks by, so the fidelity comparison is like-for-like); links that
    # never carried round traffic rank by fitted bandwidth estimates
    measured_links: List[List[Any]] = []
    for key, spec in links.items():
        src, dst_label = key.split(LINK_KEY_SEP, 1)
        f = fits[(src, dst_label)]
        if f.wire_bytes > 0 and f.wire_send_s > 0:
            measured_links.append(
                [src, dst_label, round(f.wire_bytes / f.wire_send_s, 1)]
            )
        elif f.peak_bps is not None or f.goodput_bps is not None:
            measured_links.append([src, dst_label, spec["bandwidth_bps"]])
    measured_links.sort(key=lambda item: item[2])
    observed["worst_links"] = measured_links[:10]

    coverage: Dict[str, Any] = {
        "event_rows": len(events),
        "health_records": len(healths),
        "peers_total": len(peers),
        "peers_with_compute": peers_with_compute,
        "links_fitted": len(links),
        "links_with_rtt": links_with_rtt,
        "links_rtt_backfilled_from_median": links_rtt_backfilled,
        "links_with_bandwidth": links_with_bw,
        "links_with_uplink_estimate": links_with_uplink,
        "links_from_wire_aggregates": links_from_wire,
        "links_with_loss": links_with_loss,
        "rounds_from_health_folds": rounds_from_folds,
        "workload_from_config_fields": config_fields,
        "defaults_used": sorted(
            ({"links"} if not links else set())
            | ({"compute"} if peers_with_compute == 0 else set())
            | ({"workload"} if not rounds_by_id and not config_fields
               else set())
        ),
        "warnings": warnings,
    }
    for warning in warnings:
        logger.warning(f"twin fit: {warning}")
    return TwinModel(
        peers=peers,
        links=links,
        default_link={k: float(v) for k, v in defaults.items()},
        workload=workload,
        observed=observed,
        coverage=coverage,
    )
