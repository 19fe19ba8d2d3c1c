"""Replay a fitted TwinModel in the simulator and score its fidelity.

``replay_twin`` re-instantiates the recorded swarm on the discrete-event
engine: one simulated peer per fitted peer, every fitted directed link
installed as a ``LinkSpec``, and the RECORDED workload shape (rounds,
group size, span/chunk bytes, boundaries, per-peer compute, restores)
driven by the SAME averaging-workload generator the source scenarios use
(``simulator/scenarios.run_averaging_workload``). Everything runs in
virtual time — a fleet-day of rounds costs seconds of wall.

``fidelity_report`` is the observability heart: it replays the model
against its OWN recorded workload and compares twin-predicted vs observed
metrics — round-wall p50/p95, formation latency, samples/sec, overlap
efficiency, per-peer round walls, and the worst-link ranking — emitting a
machine-readable report (rendered by ``runlog_summary --twin``) so model
drift is itself observable. The report's ``max_abs_error`` is the
fidelity bound ``tools/twin_sweep.py`` turns into a confidence interval
around every prediction: a sweep is only as trustworthy as the twin, and
the twin SAYS how trustworthy it is.

Workload overrides (the sweep's knobs) map onto the recorded shape:

- ``chunk_size`` (fp32 elements, the ``--averager.chunk_size`` knob) or
  ``chunk_bytes`` directly;
- ``compression``: none | float16 | uint8 — scales wire span bytes by the
  codec ratio relative to the recorded level;
- ``overlap``: accumulate during the round instead of before it;
- ``group_size``: re-partitions the SAME total vector — per-link span
  scales by recorded_group/new_group, partners by (new_group - 1);
- ``fetch_parallelism`` / ``restore_bytes``: the checkpoint-restore leg.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from dedloc_tpu_torch.simulator.engine import SimEngine
from dedloc_tpu_torch.simulator.network import LinkSpec, SimNetwork
from dedloc_tpu_torch.simulator.swarm import SimSwarm
from dedloc_tpu_torch.simulator.scenarios import run_averaging_workload
from dedloc_tpu_torch.twin.fit import LINK_KEY_SEP, TwinModel
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# wire bytes per fp32 element under each codec level (core/serialization)
COMPRESSION_RATIO = {"none": 1.0, "float16": 0.5, "uint8": 0.25}

# replay cost guard: enough rounds for a p50/p95, cheap enough to sweep
DEFAULT_REPLAY_ROUNDS = 4

# the fidelity pass replays the recorded workload, but a fleet-day
# recording must not turn every --twin / sweep startup into thousands of
# replayed rounds: the round-wall percentiles are statistically settled
# long before this many rounds
FIDELITY_REPLAY_ROUNDS_CAP = 12


def _workload_spec(model: TwinModel,
                   overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The averaging-workload spec for this model + overrides. Overrides
    win over the recorded workload; recorded gaps fall back to driver
    defaults (the fit's coverage already warned about them)."""
    overrides = dict(overrides or {})
    recorded = model.workload
    group_rec = int(recorded.get("group_size") or 8)
    group = int(overrides.get("group_size", group_rec))
    span_rec = int(recorded.get("span_bytes") or 98304)
    # the same total vector re-partitioned across a different group width:
    # V = span_rec * group_rec hosts a span of V/group per link
    span = int(overrides.get(
        "span_bytes", max(1024, span_rec * group_rec // max(1, group))
    ))
    compression = str(overrides.get("compression", "none")).lower()
    recorded_level = str(recorded.get("compression", "none")).lower()
    ratio = (
        COMPRESSION_RATIO.get(compression, 1.0)
        / COMPRESSION_RATIO.get(recorded_level, 1.0)
    )
    span = max(1024, int(span * ratio))
    if "chunk_size" in overrides:  # fp32 elements, the averager's knob
        chunk_bytes = max(1024, int(overrides["chunk_size"]) * 4)
    else:
        chunk_bytes = int(overrides.get(
            "chunk_bytes", recorded.get("chunk_bytes") or 24576
        ))
    rounds = overrides.get("rounds")
    if rounds is None:  # an explicit None means "pick for me" too
        rounds = min(
            DEFAULT_REPLAY_ROUNDS,
            recorded.get("rounds") or DEFAULT_REPLAY_ROUNDS,
        )
    spec: Dict[str, Any] = {
        "avg_rounds": max(1, int(rounds)),
        "group_size": group,
        "span_bytes": span,
        "chunk_bytes": min(chunk_bytes, span),
        "boundaries": int(overrides.get(
            "boundaries", recorded.get("boundaries") or 2
        )),
        "overlap": bool(overrides.get(
            "overlap", recorded.get("overlap", False)
        )),
        "window_s": float(overrides.get(
            "window_s", recorded.get("window_s") or 5.0
        )),
        "prefix": "twinreplay",
        # recorded by the replay's own run.config: a re-fit of the replay's
        # dump keeps the right compression baseline
        "compression": compression,
    }
    samples = overrides.get(
        "samples_per_boundary", recorded.get("samples_per_boundary")
    )
    if samples is not None:  # else: replay_twin's per-peer median fallback
        spec["samples_per_boundary"] = int(samples)
    if int(overrides.get(
        "restore_bytes", recorded.get("restore_bytes") or 0
    )) > 0 and (recorded.get("restores") or overrides.get("restore_bytes")):
        spec["restore_bytes"] = int(overrides.get(
            "restore_bytes", recorded.get("restore_bytes") or 0
        ))
        spec["restore_providers"] = int(overrides.get(
            "restore_providers", recorded.get("restore_providers") or 4
        ))
        spec["fetch_parallelism"] = int(
            overrides.get("fetch_parallelism", 4)
        )
    return spec


def replay_twin(
    model: TwinModel,
    overrides: Optional[Dict[str, Any]] = None,
    seed: int = 0,
    out_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Run the model's workload (with ``overrides``) on a simulated swarm
    built ENTIRELY from the fitted numbers; returns the predicted report
    (the ``run_averaging_workload`` section plus timing and the config it
    ran). ``out_dir`` dumps the replay's own per-peer JSONL — a twin run
    is itself observable by the same tools."""
    labels = sorted(model.peers)
    if len(labels) < 2:
        raise ValueError(
            f"twin has {len(labels)} peer(s); replay needs at least 2"
        )
    # fitted peer -> simulated host, in sorted-label order (sim hosts are
    # peer-0000... by spawn index; a sim-sourced twin maps onto itself)
    host_of = {label: f"peer-{i:04d}" for i, label in enumerate(labels)}
    engine = SimEngine(seed=seed)
    default_spec = LinkSpec.from_dict(model.default_link)
    link_table = {}
    for key in model.links:
        src, dst = key.split(LINK_KEY_SEP, 1)
        if src in host_of and dst in host_of:
            link_table[(host_of[src], host_of[dst])] = model.link_spec(
                src, dst
            )
    network = SimNetwork(
        seed=seed, default_link=default_spec, links=link_table
    )
    swarm = SimSwarm(network, seed=seed)
    spec = _workload_spec(model, overrides)
    spec["compute_s"] = {
        host_of[label]: float(model.peers[label].get(
            "compute_s", 0.05
        ))
        for label in labels
    }
    if "samples_per_boundary" not in spec:
        # no recorded config and no override: median of the per-peer
        # step.record fits
        spec["samples_per_boundary"] = int(
            sorted(
                float(p.get("samples_per_boundary", 16))
                for p in model.peers.values()
            )[len(labels) // 2]
        )
    wall0 = time.perf_counter()
    try:
        with engine:
            engine.run(swarm.spawn(len(labels)))
            report = engine.run(
                run_averaging_workload(swarm, spec),
                timeout=float(spec.get("virtual_timeout_s", 36000.0)),
            )
            if out_dir is not None:
                report["event_logs"] = swarm.dump_event_logs(out_dir)
            engine.run(swarm.shutdown())
    finally:
        engine.close()
    report["wall_s"] = round(time.perf_counter() - wall0, 3)
    report["seed"] = seed
    report["peers"] = len(labels)
    # predictions are keyed back to the FITTED peer labels
    unhost = {host: label for label, host in host_of.items()}
    report["per_peer_round_wall_s"] = {
        unhost.get(host, host): wall
        for host, wall in report.get("per_peer_round_wall_s", {}).items()
    }
    report["worst_links"] = [
        [unhost.get(src, src), unhost.get(dst, dst), bps]
        for src, dst, bps in report.get("worst_links", [])
    ]
    return report


def _error(observed: Optional[float],
           predicted: Optional[float]) -> Optional[float]:
    if observed is None or predicted is None or observed <= 0:
        return None
    return (predicted - observed) / observed


def fidelity_report(
    model: TwinModel,
    replay: Optional[Dict[str, Any]] = None,
    seed: int = 0,
) -> Dict[str, Any]:
    """Twin-predicted vs observed, per metric, per peer and swarm-wide —
    THE observability artifact of the twin pipeline. ``replay`` defaults
    to replaying the model's own recorded workload at full recorded round
    count (prediction and observation must describe the same workload)."""
    if replay is None:
        recorded_rounds = model.workload.get("rounds")
        replay = replay_twin(
            model,
            overrides={
                "rounds": (
                    min(int(recorded_rounds), FIDELITY_REPLAY_ROUNDS_CAP)
                    if recorded_rounds else None
                )
            },
            seed=seed,
        )
    observed = model.observed
    metrics: Dict[str, Dict[str, Optional[float]]] = {}
    for name in (
        "round_wall_p50_s", "round_wall_p95_s",
        "formation_p50_s", "formation_p95_s",
        "samples_per_sec", "overlap_efficiency",
    ):
        o = observed.get(name)
        p = replay.get(name)
        o = float(o) if o is not None else None
        p = float(p) if p is not None else None
        if o is None and p is None:
            continue
        err = _error(o, p)
        metrics[name] = {
            "observed": o,
            "predicted": p,
            "error": round(err, 4) if err is not None else None,
        }

    per_peer: Dict[str, Dict[str, Optional[float]]] = {}
    observed_walls = observed.get("per_peer_round_wall_s") or {}
    predicted_walls = replay.get("per_peer_round_wall_s") or {}
    for label in sorted(set(observed_walls) | set(predicted_walls)):
        o = observed_walls.get(label)
        p = predicted_walls.get(label)
        err = _error(o, p)
        per_peer[label] = {
            "observed_round_wall_s": o,
            "predicted_round_wall_s": p,
            "error": round(err, 4) if err is not None else None,
        }

    # worst-link ranking agreement: does the twin still point at the same
    # bottleneck links? (top-1 match + top-3 set overlap)
    obs_rank = [
        (src, dst) for src, dst, _bps in observed.get("worst_links") or []
    ]
    pred_rank = [
        (src, dst) for src, dst, _bps in replay.get("worst_links") or []
    ]
    worst_links: Dict[str, Any] = {
        "observed": [list(pair) for pair in obs_rank[:3]],
        "predicted": [list(pair) for pair in pred_rank[:3]],
    }
    def bottleneck(rank: List[tuple]) -> Optional[str]:
        """The peer most entangled in the worst links — the 'who do I
        upgrade first' answer, robust to which exact directed pair tops
        the list on a given seed."""
        counts: Dict[str, int] = {}
        for src, dst in rank[:3]:
            counts[src] = counts.get(src, 0) + 1
            counts[dst] = counts.get(dst, 0) + 1
        if not counts:
            return None
        return max(sorted(counts), key=lambda p: counts[p])

    if obs_rank and pred_rank:
        worst_links["top1_match"] = obs_rank[0] == pred_rank[0]
        k = min(3, len(obs_rank), len(pred_rank))
        worst_links["top3_overlap"] = (
            len(set(obs_rank[:k]) & set(pred_rank[:k])) / k
        )
        worst_links["bottleneck_observed"] = bottleneck(obs_rank)
        worst_links["bottleneck_predicted"] = bottleneck(pred_rank)
        worst_links["bottleneck_match"] = (
            worst_links["bottleneck_observed"]
            == worst_links["bottleneck_predicted"]
        )

    errors = [
        abs(m["error"]) for m in metrics.values()
        if m.get("error") is not None
    ]
    # the bound the sweep turns into a CI: only the metrics a sweep
    # actually predicts (throughput and round wall) — formation tails are
    # matchmaking-dynamics noise and would inflate the interval into
    # uselessness without making the throughput prediction any worse
    sweep_errors = [
        abs(metrics[name]["error"])
        for name in ("round_wall_p50_s", "samples_per_sec")
        if name in metrics and metrics[name].get("error") is not None
    ]
    report = {
        "view": "twin",
        "peers": len(model.peers),
        "links_fitted": len(model.links),
        "workload": model.workload,
        "metrics": metrics,
        "per_peer": per_peer,
        "worst_links": worst_links,
        "max_abs_error": round(max(errors), 4) if errors else None,
        "sweep_error_bound": (
            round(max(sweep_errors), 4) if sweep_errors
            else (round(max(errors), 4) if errors else None)
        ),
        "coverage": model.coverage,
        "replay_wall_s": replay.get("wall_s"),
    }
    return report
