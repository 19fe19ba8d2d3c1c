"""Swarm telemetry layer: counters + span tracing across DHT / averaging /
optimizer, with coordinator swarm-health aggregation.

See ``registry`` (the per-peer metric registry + event trace, zero overhead
when disabled), ``health`` (coordinator aggregation over the signed metrics
bus), and docs/observability.md for the operator view.
"""
from __future__ import annotations

from typing import Optional

from dedloc_tpu_torch.telemetry import registry, steps
from dedloc_tpu_torch.telemetry.health import (
    RULE_THRESHOLDS,
    build_swarm_health,
    build_topology,
    derive_rates,
    verdict_from_rates,
)
from dedloc_tpu_torch.telemetry.links import LinkTable, endpoint_key
from dedloc_tpu_torch.telemetry.watch import SwarmWatch, WatchConfig, watch_rows
from dedloc_tpu_torch.telemetry.steps import StepRecorder
from dedloc_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    Telemetry,
    active,
    adopt_trace,
    current_trace,
    enabled,
    event,
    inc,
    install,
    monotonic_clock,
    new_span_id,
    resolve,
    span,
    trace_id_for,
    uninstall,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LinkTable",
    "RULE_THRESHOLDS",
    "StepRecorder",
    "SwarmWatch",
    "Telemetry",
    "WatchConfig",
    "active",
    "adopt_trace",
    "build_swarm_health",
    "build_topology",
    "configure",
    "current_trace",
    "derive_rates",
    "enabled",
    "endpoint_key",
    "event",
    "inc",
    "install",
    "verdict_from_rates",
    "watch_rows",
    "monotonic_clock",
    "new_span_id",
    "registry",
    "resolve",
    "span",
    "steps",
    "trace_id_for",
    "uninstall",
]


def configure(args, peer: str = "") -> Optional[Telemetry]:
    """Role-entry wiring: install the process-global registry from a
    ``TelemetryArguments`` block (core/config.py ``--telemetry.*`` knobs).
    Returns the installed registry, or None when telemetry is disabled —
    the instrumented seams then cost one attribute load each."""
    if not getattr(args, "enabled", False):
        return None
    return install(
        Telemetry(
            peer=peer,
            event_log_path=args.event_log_path or None,
            link_top_k=getattr(args, "link_top_k", 8),
        )
    )


# the port's device-trace regions (``steps.region``), beside the copy above
from dedloc_tpu_torch.telemetry.steps import region  # noqa: E402

__all__.append("region")
