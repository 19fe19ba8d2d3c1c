"""Live swarm watchdog: streaming anomaly detection over the health fold.

Every diagnostic tool before this one was post-hoc: the coordinator folds
``swarm_health`` records into a JSONL nobody evaluates until a human runs
``runlog_summary``. This module closes that gap. ``SwarmWatch`` consumes
the ORDERED sequence of swarm-health records — live, inline in the
coordinator's fold loop (roles/coordinator.py), or post-hoc over any
coordinator JSONL (tools/swarm_watch.py, ``runlog_summary --incidents``) —
through the exact same code path, so a replay of the dumped JSONL
reproduces the live incident timeline bit-for-bit.

Design:

- **Rolling robust baselines.** Every watched metric (swarm samples/sec,
  round-wall p50/p95, formation p95, per-directed-link RTT/goodput,
  per-peer step-phase walls, mfu, overlap efficiency) keeps a bounded
  window of recent per-fold values; the center is the median, the spread a
  MAD floor — one GC pause cannot rewrite the baseline, and a deterministic
  simulator run (spread ~0) still judges sharply.
- **Windowed, not cumulative.** Health records carry cumulative histogram
  means; consecutive folds' ``(count, mean)`` pairs recover the per-window
  mean (``(c2*m2 - c1*m1) / (c2 - c1)``), so a straggler that turns on at
  fold k is fully visible at fold k+1 instead of diluted into a lifetime
  average. Records without counts (older peers) degrade to cumulative
  means — reported in ``coverage``, never guessed around.
- **Hysteresis.** A detector opens after ``open_after`` consecutive bad
  folds and closes only after ``close_after`` consecutive folds back
  within ``close_deviation`` of baseline; the band between the open and
  close thresholds counts toward neither, so incidents cannot flap.
- **Root-cause suppression.** Detectors run most-specific-first (churn →
  links → peers → swarm). While a specific incident is open, swarm-level
  badness (throughput down, round wall up, rule rates over threshold)
  records as an ``effect`` on it instead of opening a duplicate — one
  degraded link yields ONE incident whose effects list the collateral.
- **Attribution chain.** Every incident ends in something a human can act
  on, reusing the existing ladder: the offending peer and/or directed link
  (topology fold, PR 6), the dominant step phase (PR 8's recorder keys),
  and the trace id of a representative slow round (resolvable by
  ``runlog_summary --trace``).
- **Rules shared with the health fold.** The rule detectors apply
  ``telemetry/health.RULE_THRESHOLDS`` via ``verdict_from_rates`` — the
  ``--health`` verdict header and the watchdog cannot disagree.
- **Twin-backed retuning (ROADMAP item 4, closed loop).** A sustained
  swarm throughput regression marks itself ``retune_eligible``;
  ``twin_recommendation`` then fits a TwinModel from the run's own logs
  (``twin/fit.py``), validates it against its own recording, runs a
  BOUNDED sweep and attaches the recommended config + predicted
  samples/sec + fidelity-bounded interval. Runs with insufficient
  telemetry report ``no_recommendation: <reason>`` instead of guessing.
- **Guard-railed actuation.** A recommendation is no longer the end of the
  loop: ``ActuationGuard`` (below) lets the coordinator (or the simulator's
  closed-loop scenario) APPLY it under hard rails — per-actuation change
  bound, one actuation under observation at a time, a per-plan-epoch
  budget, and automatic rollback when the post-change throughput regresses
  past the pre-change level. Every actuation and rollback lands on the
  incident's ``effects`` list and as ``watch.actuation`` /
  ``watch.rollback`` events, so ``runlog_summary --incidents`` /
  ``swarm_watch`` audit exactly what the loop did. Operators opt out with
  ``--coordinator.actuate_retune false`` (docs/fleet.md "closed-loop
  operations").
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

from dedloc_tpu_torch.telemetry.health import (
    RULE_THRESHOLDS,
    derive_rates,
    verdict_from_rates,
)
from dedloc_tpu_torch.telemetry.registry import trace_id_for
from dedloc_tpu_torch.utils.logging import get_logger
from dedloc_tpu_torch.utils.stats import median, percentile

logger = get_logger(__name__)

# phases whose inflation points at the WIRE, not this peer's compute — a
# per-peer deviation in one of these while a link incident is open on the
# same peer is that incident's collateral, not a second root cause
_WIRE_PHASES = frozenset({"avg_wire", "collab", "data_wait"})

# incident kinds that name a specific subject; swarm-level badness defers
# to any open incident of these kinds (root-cause suppression)
_SPECIFIC_KINDS = frozenset(
    {"link_degraded", "uplink_degraded", "peer_degraded", "churn_wave",
     "peer_flapping"}
)

# an open incident of these kinds claims further swarm-level badness as an
# effect: one root cause, one incident, however many metrics it drags down
_ROOT_KINDS = _SPECIFIC_KINDS | {"swarm_regression"}

# swarm_regression metrics that constitute a THROUGHPUT regression — the
# retune trigger (a round-wall inflation at fixed workload IS lost
# samples/sec, whether or not the rate detector crossed its own threshold)
_THROUGHPUT_METRICS = frozenset(
    {"samples_per_sec", "round_wall_p50", "round_wall_p95", "mfu"}
)


@dataclass
class WatchConfig:
    """Detector knobs. Defaults are tuned so a deterministic simulator run
    detects a 2x shift within ~2 folds while a production fold cadence
    (30s) tolerates ordinary jitter."""

    baseline_window: int = 16    # folds of history per metric baseline
    warmup_folds: int = 3        # min baseline samples before judging
    open_after: int = 2          # consecutive bad folds to open
    close_after: int = 2         # consecutive good folds to close
    deviation: float = 0.5       # relative deviation that counts as bad
    close_deviation: float = 0.25  # must return within this to close
    mad_k: float = 4.0           # robust-z floor (suppresses noisy fleets)
    critical_low: float = 0.7    # low-direction |dev| >= this: critical
    critical_high: float = 1.5   # high-direction dev >= this: critical
    skew_k: float = 2.0          # peer metric must also be 2x the others
    churn_fraction: float = 0.2  # fraction vanishing in one fold
    churn_min_peers: int = 2     # ...and at least this many peers
    retune_after_folds: int = 3  # sustained throughput folds before retune


class _Baseline:
    """Rolling robust baseline: median center + MAD-floored spread."""

    __slots__ = ("values",)

    def __init__(self, window: int) -> None:
        self.values: Deque[float] = deque(maxlen=window)

    def add(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def n(self) -> int:
        return len(self.values)

    def center(self) -> float:
        return median(list(self.values))

    def spread(self) -> float:
        if len(self.values) < 2:
            return 0.0
        med = self.center()
        return median([abs(v - med) for v in self.values])


class _Detector:
    """One metric's hysteresis state machine. Judgments: "bad" counts
    toward opening, "good" toward closing, the band between counts toward
    neither. The baseline only learns folds that were not bad — an open
    incident must be judged against the PRE-incident baseline, or a slow
    drift would close itself by redefining normal."""

    __slots__ = (
        "key", "subject", "low_bad", "baseline", "bad_streak",
        "good_streak", "incident",
    )

    def __init__(self, key: str, subject: str, low_bad: bool,
                 cfg: WatchConfig) -> None:
        self.key = key
        self.subject = subject
        self.low_bad = low_bad
        self.baseline = _Baseline(cfg.baseline_window)
        self.bad_streak = 0
        self.good_streak = 0
        self.incident: Optional[Dict[str, Any]] = None

    def judge(self, value: float, cfg: WatchConfig) -> Tuple[str, float]:
        """("bad"|"good"|"mid"|"warmup", relative deviation)."""
        if self.baseline.n < cfg.warmup_folds:
            return "warmup", 0.0
        center = self.baseline.center()
        if abs(center) < 1e-12:
            # a zero baseline carries no scale to judge against: "mid"
            # lets the window learn the metric's real level instead of
            # branding any nonzero value an infinite deviation (a
            # permanently-critical incident whose JSON is unparseable)
            return "mid", 0.0
        dev = (value - center) / abs(center)
        directional = -dev if self.low_bad else dev
        # robust-z floor: on a noisy fleet the MAD grows and absorbs
        # ordinary jitter; on a deterministic replay it collapses and the
        # 2%-of-center floor keeps the division sane
        spread_floor = max(self.baseline.spread(), 0.02 * abs(center))
        z = abs(value - center) / spread_floor
        if directional >= cfg.deviation and z >= cfg.mad_k:
            return "bad", dev
        if abs(dev) <= cfg.close_deviation:
            return "good", dev
        return "mid", dev


def _severity(dev: float, low_bad: bool, cfg: WatchConfig) -> str:
    if low_bad:
        return "critical" if -dev >= cfg.critical_low else "warn"
    return "critical" if dev >= cfg.critical_high else "warn"


def _windowed(prev: Optional[Tuple[float, float]],
              cur: Optional[Tuple[float, float]]) -> Optional[float]:
    """Per-window mean from two cumulative (count, mean) observations.
    None when there is nothing new to judge this window."""
    if cur is None:
        return None
    c2, m2 = cur
    if prev is None:
        return m2 if c2 > 0 else None
    c1, m1 = prev
    if c2 > c1:
        return (c2 * m2 - c1 * m1) / (c2 - c1)
    return None


class SwarmWatch:
    """The streaming watchdog. Feed it swarm-health records in order
    (``observe_health``), read ``incidents`` / ``summary()``. Pure
    computation — no clocks, no I/O — so the same instance runs inline in
    the coordinator loop, inside the virtual-time simulator, and over a
    replayed JSONL with identical results."""

    def __init__(self, config: Optional[WatchConfig] = None) -> None:
        self.cfg = config or WatchConfig()
        self.fold = -1
        self.incidents: List[Dict[str, Any]] = []
        self._detectors: Dict[Tuple[str, str], _Detector] = {}
        self._prev_health: Optional[Dict] = None
        self._prev_t: Optional[float] = None
        self._prev_peer_stats: Dict[str, Dict[str, Tuple[float, float]]] = {}
        self._prev_labels: set = set()
        self._gone_peers: set = set()
        self._churn_detector: Optional[Dict[str, Any]] = None
        self._churn_good_streak = 0
        self._seen_throughput = False
        self._recent_rounds: Deque[Dict[str, Any]] = deque(maxlen=64)
        self.coverage: Dict[str, Any] = {
            "folds": 0, "folds_with_topology": 0, "folds_with_rounds": 0,
            "folds_with_phases": 0, "folds_with_counts": 0,
            "folds_with_time": 0, "peers_seen": 0,
        }
        self._notes: set = set()
        self.last_verdict: Optional[Dict[str, str]] = None

    # ------------------------------------------------------------ plumbing

    def _detector(self, key: str, subject: str, low_bad: bool) -> _Detector:
        d = self._detectors.get((key, subject))
        if d is None:
            d = self._detectors[(key, subject)] = _Detector(
                key, subject, low_bad, self.cfg
            )
        return d

    def open_incidents(self) -> List[Dict[str, Any]]:
        return [i for i in self.incidents if i["status"] == "open"]

    def _open(self, detector: Optional[_Detector], *, kind: str,
              metric: str, subject: str, observed: Optional[float],
              baseline: Optional[float], deviation: Optional[float],
              severity: str, t: Optional[float], step: Optional[int],
              **attribution: Any) -> Dict[str, Any]:
        incident: Dict[str, Any] = {
            "id": f"inc-{len(self.incidents):04d}",
            "kind": kind,
            "metric": metric,
            "subject": subject,
            "severity": severity,
            "status": "open",
            "opened_fold": self.fold,
            "opened_t": t,
            "opened_step": step,
            "closed_fold": None,
            "closed_t": None,
            "observed": observed,
            "baseline": baseline,
            "deviation": (
                round(deviation, 4) if deviation is not None else None
            ),
            "effects": [],
        }
        incident.update(attribution)
        self.incidents.append(incident)
        if detector is not None:
            detector.incident = incident
        return incident

    def _close(self, incident: Dict[str, Any], t: Optional[float]) -> None:
        incident["status"] = "closed"
        incident["closed_fold"] = self.fold
        incident["closed_t"] = t

    def _effect(self, incident: Dict[str, Any], metric: str,
                deviation: Optional[float]) -> None:
        """Record swarm-level collateral on a specific open incident, once
        per metric (the first — worst-to-detect — observation wins)."""
        if any(e["metric"] == metric for e in incident["effects"]):
            return
        incident["effects"].append({
            "metric": metric,
            "deviation": (
                round(deviation, 4) if deviation is not None else None
            ),
            "fold": self.fold,
        })

    def _refresh_representative(self, incident: Dict[str, Any]) -> None:
        """Attach (and, while the incident stays open, keep refreshing) the
        representative slow round: the slowest recently-seen round —
        restricted to the attributed peer's member spans when it recorded
        any, else swarm-wide. The trace id comes off the round record when
        the fold carried one, else derives deterministically from the
        round id (``registry.trace_id_for``: every member of a round seeds
        the same id, so the derived id resolves against per-peer event
        logs). New folds can bring worse evidence; the slowest wins."""
        peer = incident.get("peer")
        candidates = [
            r for r in self._recent_rounds
            if r.get("dur_s") is not None and r.get("peer") == peer
        ] if peer is not None else []
        if not candidates:
            candidates = [
                r for r in self._recent_rounds if r.get("dur_s") is not None
            ]
        if not candidates:
            return
        worst = max(candidates, key=lambda r: float(r["dur_s"]))
        dur = float(worst["dur_s"])
        current = incident.get("representative_dur_s")
        if current is not None and dur <= current:
            return
        round_id = str(worst.get("round_id", "")) or None
        incident["representative_dur_s"] = round(dur, 6)
        incident["round_id"] = round_id
        incident["trace"] = worst.get("trace") or (
            trace_id_for(round_id) if round_id else None
        )

    # ----------------------------------------------------- detector driver

    def _drive(self, key: str, subject: str, value: Optional[float],
               low_bad: bool, *, kind: str, t: Optional[float],
               step: Optional[int],
               suppress_into: Optional[List[Dict[str, Any]]] = None,
               gate_ok: bool = True,
               attribution: Optional[Dict[str, Any]] = None,
               transitions: Optional[List] = None) -> None:
        """One detector, one fold. ``suppress_into``: open specific
        incidents that claim this metric's badness as an effect instead of
        a new incident. ``gate_ok=False`` vetoes OPENING this fold (e.g.
        the peer-skew gate) without resetting the baseline machinery."""
        if value is None:
            return
        d = self._detector(key, subject, low_bad)
        verdict, dev = d.judge(value, self.cfg)
        bad = verdict == "bad" and gate_ok
        # suppression applies only while THIS detector has no incident of
        # its own: an open incident keeps driving its own lifecycle (and
        # must never absorb its own metric as an "effect")
        if bad and suppress_into and d.incident is None:
            for inc in suppress_into:
                if inc is not d.incident:
                    self._effect(inc, key, dev)
            # learns nothing this fold (the value is anomalous), opens
            # nothing (the root cause is already an incident)
            d.bad_streak = 0
            d.good_streak = 0
            return
        if bad:
            d.bad_streak += 1
            d.good_streak = 0
        elif verdict == "good":
            d.good_streak += 1
            d.bad_streak = 0
        else:
            d.bad_streak = 0
            d.good_streak = 0
        if verdict != "bad":
            # "mid", "good" and warmup folds refine the baseline; bad
            # folds must not teach it the anomaly (judge() never says
            # "bad" during warmup, so warmup always lands here)
            d.baseline.add(value)

        if d.incident is None:
            if bad and d.bad_streak >= self.cfg.open_after:
                incident = self._open(
                    d, kind=kind, metric=key, subject=subject,
                    observed=round(value, 6),
                    baseline=round(d.baseline.center(), 6),
                    deviation=dev,
                    severity=_severity(dev, low_bad, self.cfg),
                    t=t, step=step, **(attribution or {}),
                )
                self._refresh_representative(incident)
                if transitions is not None:
                    transitions.append(
                        {"transition": "open", "incident": incident}
                    )
        else:
            incident = d.incident
            if bad:
                # live update: the current reading and (escalating only)
                # severity track the worst of the incident
                incident["observed"] = round(value, 6)
                incident["deviation"] = round(dev, 4)
                if _severity(dev, low_bad, self.cfg) == "critical":
                    incident["severity"] = "critical"
                self._refresh_representative(incident)
            if d.good_streak >= self.cfg.close_after:
                self._close(incident, t)
                d.incident = None
                if transitions is not None:
                    transitions.append(
                        {"transition": "close", "incident": incident}
                    )

    # ------------------------------------------------------------- folding

    def observe_health(
        self,
        health: Dict[str, Any],
        t: Optional[float] = None,
        step: Optional[int] = None,
        samples_per_sec: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Consume one swarm-health record; returns the fold's incident
        transitions (``[{"transition": "open"|"close", "incident": ...}]``,
        each referencing the LIVE incident dict)."""
        cfg = self.cfg
        self.fold += 1
        cov = self.coverage
        cov["folds"] += 1
        transitions: List[Dict[str, Any]] = []
        peers = [
            p for p in health.get("peers", []) if isinstance(p, dict)
        ]
        labels = {str(p.get("peer")) for p in peers if p.get("peer")}
        cov["peers_seen"] = max(cov["peers_seen"], len(labels))
        if step is None:
            step = health.get("current_step")
        dt = None
        if t is not None and self._prev_t is not None and t > self._prev_t:
            dt = t - self._prev_t
        if t is not None:
            cov["folds_with_time"] += 1

        rounds = health.get("rounds") or []
        if rounds:
            cov["folds_with_rounds"] += 1
            for r in rounds:
                if isinstance(r, dict):
                    self._recent_rounds.append(r)

        # ------------------------------------------------------ churn wave
        # a peer that came back is no longer "gone": it may die again
        # later, and that second death must count
        self._gone_peers -= labels
        lost = (self._prev_labels - labels) - self._gone_peers
        if self._prev_labels:
            threshold = max(
                cfg.churn_min_peers,
                int(cfg.churn_fraction * len(self._prev_labels)),
            )
            if self._churn_detector is None:
                if len(lost) >= threshold:
                    incident = self._open(
                        None, kind="churn_wave", metric="peers_lost",
                        subject="swarm", observed=float(len(lost)),
                        baseline=float(len(self._prev_labels)),
                        deviation=-len(lost) / len(self._prev_labels),
                        severity="critical", t=t, step=step,
                        peers_lost=sorted(lost),
                    )
                    self._refresh_representative(incident)
                    self._churn_detector = incident
                    self._churn_good_streak = 0
                    transitions.append(
                        {"transition": "open", "incident": incident}
                    )
            else:
                incident = self._churn_detector
                if lost:
                    incident["peers_lost"] = sorted(
                        set(incident["peers_lost"]) | lost
                    )
                    incident["observed"] = float(
                        len(incident["peers_lost"])
                    )
                    self._churn_good_streak = 0
                else:
                    self._churn_good_streak += 1
                    if self._churn_good_streak >= cfg.close_after:
                        self._close(incident, t)
                        self._churn_detector = None
                        transitions.append(
                            {"transition": "close", "incident": incident}
                        )
        self._gone_peers |= lost

        # ------------------------------------------------- per-link health
        links: Dict[Tuple[str, str], Dict[str, float]] = {}
        topology = health.get("topology")
        if isinstance(topology, dict):
            cov["folds_with_topology"] += 1
            for link in topology.get("links", []):
                if not isinstance(link, dict):
                    continue
                src = str(link.get("src", "?"))
                dst = str(link.get("dst", link.get("dst_endpoint", "?")))
                links[(src, dst)] = link
        # per-peer windowed stats (needed for link-phase attribution below,
        # so computed before the link detectors run)
        peer_stats: Dict[str, Dict[str, Tuple[float, float]]] = {}
        windowed_phase: Dict[str, Dict[str, float]] = {}
        windowed_round: Dict[str, float] = {}
        windowed_formation: List[float] = []
        any_phases = any_counts = False
        for p in peers:
            label = str(p.get("peer", "?"))
            cur: Dict[str, Tuple[float, float]] = {}
            phases = p.get("phases")
            phase_counts = p.get("phase_counts") or {}
            if isinstance(phases, dict) and phases:
                any_phases = True
                for name, mean in phases.items():
                    count = phase_counts.get(name)
                    if count is not None:
                        any_counts = True
                        cur[f"phase.{name}"] = (float(count), float(mean))
                    else:
                        cur[f"phase.{name}"] = (
                            float(self.fold + 1), float(mean)
                        )
                        self._notes.add(
                            "phase means without sample counts (older "
                            "peers): windowing approximated by fold index"
                        )
            if p.get("round_s") is not None:
                count = p.get("round_count")
                if count is None:
                    count = float(self.fold + 1)
                    self._notes.add(
                        "round means without sample counts (older peers): "
                        "windowing approximated by fold index"
                    )
                cur["round"] = (float(count), float(p["round_s"]))
            if p.get("round_formation_s") is not None:
                count = p.get("round_formation_count")
                if count is None:
                    count = float(self.fold + 1)
                cur["formation"] = (
                    float(count), float(p["round_formation_s"])
                )
            prev = self._prev_peer_stats.get(label, {})
            for key, pair in cur.items():
                w = _windowed(prev.get(key), pair)
                if w is None:
                    continue
                # dedlint: disable=schema-consumed-unknown — "phase." is
                # the fold's OWN per-peer stat namespace (health records),
                # not a telemetry emit name
                if key.startswith("phase."):  # dedlint: disable=schema-consumed-unknown
                    windowed_phase.setdefault(label, {})[
                        key[len("phase."):]
                    ] = w
                elif key == "round":
                    windowed_round[label] = w
                elif key == "formation":
                    windowed_formation.append(w)
            peer_stats[label] = cur
        if any_phases:
            cov["folds_with_phases"] += 1
        if any_counts:
            cov["folds_with_counts"] += 1

        def _phase_attribution(label: str) -> Optional[str]:
            """The peer's most-deviating windowed phase vs its own
            baseline — the 'and WHY' rung of the ladder."""
            best_name, best_dev = None, 0.0
            for name, value in (windowed_phase.get(label) or {}).items():
                d = self._detector(f"peer_phase.{name}", f"peer:{label}",
                                   low_bad=False)
                if d.baseline.n < cfg.warmup_folds:
                    continue
                center = d.baseline.center()
                if center <= 1e-12:
                    continue
                dev = (value - center) / center
                if dev > best_dev:
                    best_name, best_dev = name, dev
            return best_name if best_dev >= cfg.deviation else None

        # a sender's outgoing links share one serialized uplink: when the
        # uplink itself degrades, EVERY outgoing goodput collapses together
        # — that is ONE uplink event, not N link incidents. A link only
        # earns its own incident when it is distinguishably worse than its
        # siblings; the per-src uplink detector (median outgoing goodput)
        # owns the collapse-together case.
        goodput_by_src: Dict[str, Dict[str, float]] = {}
        for (src, dst), link in links.items():
            if link.get("goodput_bps") is not None:
                goodput_by_src.setdefault(src, {})[dst] = float(
                    link["goodput_bps"]
                )
        for (src, dst), link in sorted(links.items()):
            subject = f"link:{src}->{dst}"
            goodput = link.get("goodput_bps")
            if goodput is not None:
                siblings = [
                    g for d, g in goodput_by_src.get(src, {}).items()
                    if d != dst
                ]
                gate_ok = len(siblings) < 2 or float(goodput) <= (
                    0.5 * median(siblings)
                )
                self._drive(
                    "link_goodput", subject, float(goodput), low_bad=True,
                    kind="link_degraded", t=t, step=step, gate_ok=gate_ok,
                    attribution={
                        "peer": src, "link": {"src": src, "dst": dst},
                        "phase": _phase_attribution(src),
                    },
                    transitions=transitions,
                )
            rtt = link.get("rtt_s")
            if rtt is not None:
                self._drive(
                    "link_rtt", subject, float(rtt), low_bad=False,
                    kind="link_degraded", t=t, step=step,
                    attribution={
                        "peer": src, "link": {"src": src, "dst": dst},
                        "phase": _phase_attribution(src),
                    },
                    transitions=transitions,
                )
        uplink_medians = {
            src: median(list(outgoing.values()))
            for src, outgoing in goodput_by_src.items()
        }
        for src, outgoing in sorted(goodput_by_src.items()):
            if len(outgoing) < 3:
                continue  # too few links to call it an uplink property
            # vs-swarm gate (same shape as the peer-phase skew gate): when
            # EVERY peer's uplink collapses together the event is
            # swarm-wide — wire path, config push, provider outage — and
            # belongs to the swarm detectors, not to N uplink incidents
            others = [
                v for other, v in uplink_medians.items() if other != src
            ]
            gate_ok = len(others) < 2 or uplink_medians[src] <= (
                0.5 * median(others)
            )
            self._drive(
                "uplink_goodput", f"uplink:{src}",
                uplink_medians[src], low_bad=True,
                kind="uplink_degraded", t=t, step=step, gate_ok=gate_ok,
                attribution={
                    "peer": src, "phase": _phase_attribution(src),
                },
                transitions=transitions,
            )

        open_link_incidents = [
            i for i in self.open_incidents()
            if i["kind"] in ("link_degraded", "uplink_degraded")
        ]

        # ------------------------------------------------- per-peer health
        for p in peers:
            label = str(p.get("peer", "?"))
            calls = float(p.get("rpc_calls", 0.0))
            lost_conns = float(p.get("conns_lost", 0.0))
            if calls >= 20:
                ratio = lost_conns / calls
                limit = RULE_THRESHOLDS["peer_loss_ratio"]
                self._drive_rule(
                    "peer_loss_ratio", f"peer:{label}", ratio, limit,
                    kind="peer_flapping", t=t, step=step,
                    attribution={"peer": label},
                    transitions=transitions,
                )
            for name, value in sorted(
                (windowed_phase.get(label) or {}).items()
            ):
                # skew gate: the peer must ALSO stand out from the rest of
                # the swarm right now — a global slowdown is a swarm
                # incident, not N peer incidents
                others = [
                    v[name] for other, v in windowed_phase.items()
                    if other != label and name in v
                ]
                gate_ok = True
                if len(others) >= 2:
                    gate_ok = value >= cfg.skew_k * max(
                        median(others), 1e-12
                    )
                suppress = [
                    i for i in open_link_incidents
                    if i.get("peer") == label and name in _WIRE_PHASES
                ]
                self._drive(
                    f"peer_phase.{name}", f"peer:{label}", value,
                    low_bad=False, kind="peer_degraded", t=t, step=step,
                    gate_ok=gate_ok, suppress_into=suppress,
                    attribution={"peer": label, "phase": name},
                    transitions=transitions,
                )

        def _open_roots() -> List[Dict[str, Any]]:
            """Open incidents that claim swarm-level badness as effects —
            recomputed per metric so the first swarm incident a fold opens
            absorbs the fold's remaining swarm-level deviations."""
            return [
                i for i in self.open_incidents()
                if i["kind"] in _ROOT_KINDS
            ]

        # --------------------------------------------------- swarm metrics
        if samples_per_sec is None:
            reported = [
                float(p["samples_per_second"]) for p in peers
                if p.get("samples_per_second") is not None
            ]
            if reported:
                total = sum(reported)
                if total > 0:
                    samples_per_sec = total
                elif self._seen_throughput:
                    # a measured all-zero window once the swarm has ever
                    # reported throughput is a TOTAL collapse — judged at
                    # −100%, not skipped as missing data; before that,
                    # zeros are first-fold placeholders (no rate window
                    # existed yet)
                    samples_per_sec = 0.0
        if samples_per_sec is not None and samples_per_sec > 0:
            self._seen_throughput = True

        round_walls: List[float] = []
        if rounds:
            round_walls = [
                float(r["dur_s"]) for r in rounds
                if isinstance(r, dict) and r.get("dur_s") is not None
                and r.get("ok") is not False
            ]
        elif windowed_round:
            round_walls = sorted(windowed_round.values())
            self._notes.add(
                "no round summaries in folds: round-wall percentiles "
                "derived from per-peer windowed means"
            )

        def _swarm_peer_attribution() -> Dict[str, Any]:
            """Best-effort peer/link/phase for a swarm-level incident: the
            peer whose windowed round wall most exceeds the others."""
            out: Dict[str, Any] = {}
            if len(windowed_round) >= 2:
                worst = max(windowed_round, key=windowed_round.get)
                rest = [
                    v for k, v in windowed_round.items() if k != worst
                ]
                if windowed_round[worst] >= cfg.skew_k * max(
                    median(rest), 1e-12
                ):
                    out["peer"] = worst
                    out["phase"] = _phase_attribution(worst)
            if "peer" not in out and health.get("straggler"):
                out["peer"] = health["straggler"]
            return out

        swarm_metrics: List[Tuple[str, Optional[float], bool]] = [
            ("samples_per_sec", samples_per_sec, True),
            (
                "round_wall_p50",
                percentile(round_walls, 0.50) if round_walls else None,
                False,
            ),
            (
                "round_wall_p95",
                percentile(round_walls, 0.95) if round_walls else None,
                False,
            ),
            (
                "formation_p95",
                percentile(windowed_formation, 0.95)
                if windowed_formation else None,
                False,
            ),
        ]
        mfus = [float(p["mfu"]) for p in peers if p.get("mfu") is not None]
        if mfus:
            swarm_metrics.append(("mfu", sum(mfus) / len(mfus), True))
        effs = [
            float(p["overlap_efficiency"]) for p in peers
            if p.get("overlap_efficiency") is not None
        ]
        if effs:
            swarm_metrics.append(
                ("overlap_efficiency", sum(effs) / len(effs), True)
            )
        for key, value, low_bad in swarm_metrics:
            self._drive(
                key, "swarm", value, low_bad=low_bad,
                kind="swarm_regression", t=t, step=step,
                suppress_into=_open_roots(),
                attribution=_swarm_peer_attribution(),
                transitions=transitions,
            )

        # ------------------------------------------------------ rule rates
        rates = health.get("derived")
        if not isinstance(rates, dict) or self._prev_health is not None:
            # recompute windowed against the previous fold when we can —
            # the record's own "derived" is cumulative-by-construction
            rates = derive_rates(health, prev=self._prev_health, dt_s=dt)
        for key in ("round_abort_rate", "join_failure_rate",
                    "conns_lost_per_min"):
            value = rates.get(key)
            if value is None:
                continue
            self._drive_rule(
                key, "swarm", float(value), RULE_THRESHOLDS[key],
                kind="rule", t=t, step=step,
                suppress_into=_open_roots(),
                transitions=transitions,
            )
        self.last_verdict = dict(health.get("verdict") or {})
        if not self.last_verdict:
            status, reason = verdict_from_rates(
                rates, health.get("straggler")
            )
            self.last_verdict = {"status": status, "reason": reason}

        # retune eligibility: a sustained swarm-level throughput regression
        # (directly, or as the absorbed effect of the fold's root incident)
        for incident in self.open_incidents():
            throughput_hit = incident["kind"] == "swarm_regression" and (
                incident["metric"] in _THROUGHPUT_METRICS
                or any(
                    e["metric"] in _THROUGHPUT_METRICS
                    for e in incident["effects"]
                )
            )
            if (
                throughput_hit
                and not incident.get("retune_eligible")
                and self.fold - incident["opened_fold"]
                >= cfg.retune_after_folds - 1
            ):
                incident["retune_eligible"] = True
                transitions.append(
                    {"transition": "retune_eligible", "incident": incident}
                )

        self._prev_health = health
        self._prev_t = t if t is not None else self._prev_t
        self._prev_peer_stats = peer_stats
        self._prev_labels = labels
        return transitions

    def _drive_rule(self, key: str, subject: str, value: float,
                    limit: float, *, kind: str, t: Optional[float],
                    step: Optional[int],
                    suppress_into: Optional[List[Dict[str, Any]]] = None,
                    attribution: Optional[Dict[str, Any]] = None,
                    transitions: Optional[List] = None) -> None:
        """Absolute-threshold rule with the same hysteresis machinery:
        bad above ``limit``, good below half of it."""
        d = self._detector(f"rule.{key}", subject, low_bad=False)
        bad = value > limit
        good = value <= 0.5 * limit
        if bad and suppress_into:
            for inc in suppress_into:
                self._effect(inc, key, value / limit - 1.0)
            d.bad_streak = d.good_streak = 0
            return
        if bad:
            d.bad_streak += 1
            d.good_streak = 0
        elif good:
            d.good_streak += 1
            d.bad_streak = 0
        else:
            d.bad_streak = d.good_streak = 0
        if d.incident is None:
            if bad and d.bad_streak >= self.cfg.open_after:
                incident = self._open(
                    d, kind=kind, metric=key, subject=subject,
                    observed=round(value, 6), baseline=limit,
                    deviation=round(value / limit - 1.0, 4),
                    severity=(
                        "critical" if value > 2.0 * limit else "warn"
                    ),
                    t=t, step=step, **(attribution or {}),
                )
                self._refresh_representative(incident)
                if transitions is not None:
                    transitions.append(
                        {"transition": "open", "incident": incident}
                    )
        else:
            incident = d.incident
            if bad:
                incident["observed"] = round(value, 6)
                incident["deviation"] = round(value / limit - 1.0, 4)
            if d.good_streak >= self.cfg.close_after:
                self._close(incident, t)
                d.incident = None
                if transitions is not None:
                    transitions.append(
                        {"transition": "close", "incident": incident}
                    )

    # ------------------------------------------------------------- summary

    def summary(self) -> Dict[str, Any]:
        """The watchdog's machine-readable state: incidents (open first,
        then by opening fold), coverage — every blind spot the input had is
        NAMED, never silently absorbed — and the latest shared verdict."""
        cov = dict(self.coverage)
        notes = set(self._notes)
        if cov["folds"]:
            if not cov["folds_with_topology"]:
                notes.add(
                    "no topology in any fold (pre-link peers or telemetry "
                    "off): link detectors idle"
                )
            if not cov["folds_with_phases"]:
                notes.add(
                    "no step-phase data in any fold (pre-recorder peers): "
                    "phase attribution unavailable"
                )
            if not cov["folds_with_rounds"]:
                notes.add(
                    "no round summaries in any fold: representative-trace "
                    "attribution unavailable"
                )
            if not cov["folds_with_time"]:
                notes.add(
                    "no fold timestamps: per-minute rule rates skipped"
                )
        cov["notes"] = sorted(notes)
        ordered = sorted(
            self.incidents,
            key=lambda i: (i["status"] != "open", i["opened_fold"]),
        )
        return {
            "view": "watch",
            "folds": cov["folds"],
            "incidents": ordered,
            "open": len(self.open_incidents()),
            "coverage": cov,
            "verdict": self.last_verdict,
        }


# ---------------------------------------------------------------------------
# Post-hoc replay: the SAME watchdog over loaded JSONL rows.
# ---------------------------------------------------------------------------


def watch_rows(rows: List[Dict[str, Any]],
               config: Optional[WatchConfig] = None) -> SwarmWatch:
    """Replay a coordinator metrics JSONL (already loaded, e.g. via the
    shared ``load_jsonl_rows`` loader) through a fresh ``SwarmWatch``.
    Rows without a ``swarm_health`` record are skipped — they are the
    throughput aggregates and stray telemetry the same file carries."""
    watch = SwarmWatch(config)
    for row in rows:
        if not isinstance(row, dict):
            continue
        health = row.get("swarm_health")
        if not isinstance(health, dict):
            continue
        t = row.get("time")
        watch.observe_health(
            health,
            t=float(t) if t is not None else None,
            step=row.get("step"),
            samples_per_sec=row.get("samples_per_second"),
        )
    return watch


# ---------------------------------------------------------------------------
# Twin-backed retuning (ROADMAP item 4's closed loop): recommendation fit +
# the guard-railed actuation machinery that applies it (ISSUE 16).
# ---------------------------------------------------------------------------

# bounded by construction: the sweep the watchdog runs on an incident is a
# handful of replays, not the full tools/twin_sweep.py grid
RETUNE_MAX_CONFIGS = 4
RETUNE_REPLAY_ROUNDS = 2


def twin_recommendation(
    rows: List[Dict[str, Any]],
    seed: int = 0,
    grid: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Fit a TwinModel from the run's own telemetry rows, validate it
    against its own recording, sweep a small config grid and return either
    a recommendation (``config`` + ``predicted_samples_per_sec`` +
    fidelity-bounded ``interval``) or ``{"no_recommendation": <reason>}``.
    Never raises on bad input — an incident with no usable telemetry gets
    a reason, not a guess (and never a crash in the coordinator loop)."""
    from dedloc_tpu_torch.twin.fit import fit_twin
    from dedloc_tpu_torch.twin.replay import fidelity_report, replay_twin

    try:
        model = fit_twin(rows)
    except ValueError as e:
        return {"no_recommendation": f"twin not fittable: {e}"}
    cov = model.coverage
    if cov.get("links_with_bandwidth", 0) == 0:
        return {"no_recommendation": (
            "insufficient coverage: no link bandwidth was measured "
            "(pre-link-schema peers or telemetry off)"
        )}
    if cov.get("peers_with_compute", 0) == 0:
        return {"no_recommendation": (
            "insufficient coverage: no per-peer compute was measured "
            "(pre-step-recorder peers)"
        )}
    if not model.workload.get("rounds"):
        return {"no_recommendation": (
            "insufficient coverage: no recorded rounds — the workload "
            "shape is unknown"
        )}
    try:
        fidelity = fidelity_report(model, seed=seed)
    except Exception as e:  # noqa: BLE001 — a replay failure is a reason
        return {"no_recommendation": f"twin replay failed: {e!r}"}
    bound = fidelity.get("sweep_error_bound")
    if bound is None:
        return {"no_recommendation": (
            "twin unvalidated: the recording carries no observed rounds "
            "to bound the prediction error"
        )}
    if bound > 1.0:
        # a twin that misses its own recording by over 100% predicts
        # nothing — saying so beats recommending from noise
        return {"no_recommendation": (
            f"twin fidelity insufficient (error bound "
            f"±{bound * 100.0:.0f}% against its own recording)"
        )}
    if grid is None:
        chunk_rec = int(
            (model.workload.get("chunk_bytes") or 24576) // 4
        )
        span_elems = max(
            chunk_rec, int((model.workload.get("span_bytes") or 98304) // 4)
        )
        grid = [
            {"chunk_size": chunk_rec, "overlap": False},
            {"chunk_size": min(chunk_rec * 4, span_elems),
             "overlap": False},
            {"chunk_size": chunk_rec, "overlap": True},
            {"chunk_size": min(chunk_rec * 4, span_elems),
             "overlap": True},
        ]
    grid = grid[:RETUNE_MAX_CONFIGS]
    results = []
    for config in grid:
        overrides = dict(config)
        overrides["rounds"] = RETUNE_REPLAY_ROUNDS
        try:
            report = replay_twin(model, overrides=overrides, seed=seed)
        except Exception as e:  # noqa: BLE001 — a failed config reports
            results.append({"config": config, "error": repr(e)})
            continue
        results.append({
            "config": config,
            "samples_per_sec": report.get("samples_per_sec"),
            "round_wall_p50_s": report.get("round_wall_p50_s"),
        })
    ok = [r for r in results if r.get("samples_per_sec")]
    if not ok:
        return {"no_recommendation": (
            "no sweep config produced a throughput prediction"
        ), "configs": results}
    best = max(ok, key=lambda r: r["samples_per_sec"])
    predicted = float(best["samples_per_sec"])
    return {
        "config": best["config"],
        "predicted_samples_per_sec": round(predicted, 3),
        "interval": [
            round(max(0.0, predicted * (1.0 - bound)), 3),
            round(predicted * (1.0 + bound), 3),
        ],
        "fidelity_bound": bound,
        "configs_evaluated": len(results),
        "observed_samples_per_sec": model.observed.get("samples_per_sec"),
    }


# actuation-eligible config keys (the twin sweep's grid keys — see the
# default grid in twin_recommendation): anything else a recommendation
# carries is reported but never applied
ACTUATION_KEYS = ("chunk_size", "overlap")


@dataclass
class ActuationConfig:
    """Guard-rail knobs for applying a twin recommendation (docs/fleet.md
    "closed-loop operations"). Defaults are deliberately conservative: one
    bounded change at a time, judged within a handful of folds."""

    # numeric keys move at most this factor from the current value per
    # actuation (a 64x chunk-size jump becomes two guarded 4x–16x steps)
    max_change_factor: float = 4.0
    # folds to let the change take effect before judging it
    settle_folds: int = 1
    # post-settle folds the change must survive to be kept
    observe_folds: int = 3
    # rollback when post-change samples/sec drops below
    # (1 - rollback_margin) x the pre-change level
    rollback_margin: float = 0.1
    # folds between actuations (after a verdict, either way)
    cooldown_folds: int = 4
    # actuations per topology-plan epoch — a re-plan resets the budget
    max_actuations_per_epoch: int = 2


class ActuationGuard:
    """The guard rail between a twin recommendation and the running swarm.

    Pure computation like ``SwarmWatch`` — no clocks, no I/O, fold indices
    come from the caller — so the coordinator's live loop and the
    simulator's virtual-time closed-loop scenario share this one
    implementation. Protocol: ``consider`` clamps a recommendation into an
    applicable delta (or refuses with a reason), the caller applies it and
    calls ``actuate`` (which records the incident effect), then feeds every
    subsequent fold's swarm samples/sec into ``observe`` until a verdict —
    ``"rollback"`` (the caller must re-apply ``record["revert"]`` and
    append the rollback effect via ``rollback_effect``) or ``"kept"``."""

    def __init__(self, config: Optional[ActuationConfig] = None) -> None:
        self.cfg = config or ActuationConfig()
        self.active: Optional[Dict[str, Any]] = None
        self.history: List[Dict[str, Any]] = []
        self._cooldown_until = -1
        self._per_epoch: Dict[int, int] = {}

    def consider(
        self,
        recommendation: Dict[str, Any],
        current_config: Dict[str, Any],
        *,
        fold: int,
        epoch: int = 0,
    ) -> Dict[str, Any]:
        """Clamp ``recommendation["config"]`` against the guard rails.
        Returns ``{"apply": delta, "revert": previous, "clamped": keys}``
        or ``{"refused": reason}`` — never raises."""
        cfg = self.cfg
        if self.active is not None:
            return {"refused": (
                f"actuation {self.active['applied']} from fold "
                f"{self.active['fold']} is still under observation"
            )}
        if fold < self._cooldown_until:
            return {"refused": (
                f"in post-actuation cooldown until fold "
                f"{self._cooldown_until}"
            )}
        if self._per_epoch.get(epoch, 0) >= cfg.max_actuations_per_epoch:
            return {"refused": (
                f"actuation budget exhausted for plan epoch {epoch} "
                f"({cfg.max_actuations_per_epoch} per epoch)"
            )}
        config = recommendation.get("config") or {}
        applied: Dict[str, Any] = {}
        revert: Dict[str, Any] = {}
        clamped: List[str] = []
        for key in ACTUATION_KEYS:
            if key not in config:
                continue
            want, cur = config[key], current_config.get(key)
            if want == cur:
                continue
            if isinstance(want, bool) or isinstance(cur, bool):
                applied[key] = bool(want)
            elif (
                isinstance(want, (int, float))
                and isinstance(cur, (int, float))
                and cur > 0
            ):
                bounded = min(
                    max(float(want), cur / cfg.max_change_factor),
                    cur * cfg.max_change_factor,
                )
                if isinstance(cur, int):
                    bounded = int(round(bounded))
                if bounded != want:
                    clamped.append(key)
                if bounded == cur:
                    continue
                applied[key] = bounded
            else:
                applied[key] = want
            revert[key] = cur
        if not applied:
            return {"refused": (
                "recommended config matches the current config "
                "(nothing to apply within the guard rail)"
            )}
        return {"apply": applied, "revert": revert, "clamped": clamped}

    def actuate(
        self,
        incident: Dict[str, Any],
        applied: Dict[str, Any],
        revert: Dict[str, Any],
        *,
        fold: int,
        baseline_samples_per_sec: Optional[float],
        epoch: int = 0,
        clamped: Tuple[str, ...] = (),
    ) -> Dict[str, Any]:
        """Record a just-applied config delta and start observing it.
        Appends the ``actuation`` effect to the incident and returns the
        live actuation record (also kept in ``history``)."""
        record: Dict[str, Any] = {
            "incident": incident.get("id"),
            "applied": dict(applied),
            "revert": dict(revert),
            "clamped": list(clamped),
            "fold": fold,
            "epoch": epoch,
            "baseline_samples_per_sec": baseline_samples_per_sec,
            "observed": [],
            "verdict": "observing",
        }
        self.active = record
        self.history.append(record)
        self._per_epoch[epoch] = self._per_epoch.get(epoch, 0) + 1
        verdict = "applied"
        if clamped:
            verdict += f" (guard-rail clamped: {', '.join(clamped)})"
        incident.setdefault("effects", []).append({
            "metric": "actuation",
            "deviation": None,
            "fold": fold,
            "applied": dict(applied),
            "verdict": verdict,
        })
        return record

    def observe(self, samples_per_sec: Optional[float],
                *, fold: int) -> Optional[Dict[str, Any]]:
        """Judge the active actuation against one more fold's swarm
        throughput. Returns the actuation record once a verdict lands
        (``record["verdict"]`` is ``"rollback"`` or ``"kept"``), else
        None. The pre-change level — NOT the pre-incident baseline — is
        the rollback reference: the actuation exists because throughput
        already regressed, so the rail only asks "did the change make it
        WORSE", never "did it fix everything"."""
        record = self.active
        if record is None or samples_per_sec is None:
            return None
        if fold - record["fold"] < self.cfg.settle_folds:
            return None
        value = float(samples_per_sec)
        record["observed"].append(round(value, 6))
        baseline = record.get("baseline_samples_per_sec")
        if (
            baseline
            and value < (1.0 - self.cfg.rollback_margin) * float(baseline)
        ):
            record["verdict"] = "rollback"
            record["verdict_fold"] = fold
            self.active = None
            self._cooldown_until = fold + self.cfg.cooldown_folds
            return record
        if len(record["observed"]) >= self.cfg.observe_folds:
            record["verdict"] = "kept"
            record["verdict_fold"] = fold
            self.active = None
            self._cooldown_until = fold + self.cfg.cooldown_folds
            return record
        return None


def rollback_effect(incident: Dict[str, Any],
                    record: Dict[str, Any]) -> Dict[str, Any]:
    """Append (and return) the ``rollback`` effect for a rolled-back
    actuation — the caller re-applies ``record["revert"]`` itself and then
    records the fact here, so the incident chain reads
    actuation → rollback in ``runlog_summary --incidents``."""
    baseline = record.get("baseline_samples_per_sec")
    observed = record["observed"][-1] if record.get("observed") else None
    deviation = None
    if baseline and observed is not None:
        deviation = round(float(observed) / float(baseline) - 1.0, 4)
    effect = {
        "metric": "rollback",
        "deviation": deviation,
        "fold": record.get("verdict_fold", record["fold"]),
        "applied": dict(record.get("revert") or {}),
        "verdict": (
            "post-change samples/sec regressed past the pre-change level"
        ),
    }
    incident.setdefault("effects", []).append(effect)
    return effect


def attach_recommendation(
    incident: Dict[str, Any],
    rows: List[Dict[str, Any]],
    seed: int = 0,
    grid: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Compute and attach the twin-backed recommendation for one
    retune-eligible incident. Idempotent: an incident that already carries
    a recommendation (or a reason) is returned unchanged."""
    if "recommendation" in incident or "recommendation_reason" in incident:
        return incident
    result = twin_recommendation(rows, seed=seed, grid=grid)
    if "no_recommendation" in result:
        incident["recommendation_reason"] = result["no_recommendation"]
        logger.warning(
            f"watchdog incident {incident['id']}: no retuning "
            f"recommendation — {result['no_recommendation']}"
        )
    else:
        incident["recommendation"] = result
        logger.info(
            f"watchdog incident {incident['id']}: twin recommends "
            f"{result['config']} (predicted "
            f"{result['predicted_samples_per_sec']} samples/sec, "
            f"±{result['fidelity_bound'] * 100:.0f}%)"
        )
    return incident
