"""The program's own regions in a profiled stretch: every device operation
and every idle gap of the device charged to the ``dedloc.*`` region of the
port (``dedloc_tpu_torch/telemetry/steps.py`` ``region``) that launched it.

``attribute(trace, steps)`` reads one chrome trace taken with the CPU and
CUDA activities:

- a device operation (kernel, memcpy, memset) goes to the regions open on
  the thread that launched it (the ``cuda_runtime`` or ``cuda_driver``
  event of the same ``correlation``) when it was launched;
- one launched inside a backward node (autograd's ``evaluate_function``)
  and in no region opened inside that node goes to the regions of the
  forward operation the node differentiates, found by the trace's
  ``fwdbwd`` flow (torch 2.11 writes one for each node); the outermost of
  those regions (the forward's phase) is left out;
- the phase is the outermost region: the launching thread's, or a region
  on another thread opened before it (``bwd``, on the thread that waits
  in ``torch.autograd.grad`` while autograd's device thread launches the
  backward);
- an idle gap between two busy stretches of the device goes to the
  operation that ended it: what the device waited for.

Device time is each operation's share of the busy time (the union of the
operations' intervals, each instant counted for the operation that reached
it first), so the phases and ``untraced`` (no launch found, or launched
outside every region) sum to the busy time exactly, and their idle ms to
the idle time between the stretch's first and last device operation.

``tables(run)`` takes the stretch once per traced run: the harness frees
the program it timed before the readers run, so the stretch is taken on a
second build of the cell's program from the same seed, warmed as the first
was, over the cell's ``profile_steps`` steps. The tables are kept on
``run.regions``; they are None off the card, and where the trace holds no
``dedloc.`` region (a program without them).
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

from portbench.harness import log

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")
PREFIX = "dedloc."
NODE = "autograd::engine::evaluate_function: "
BOUNDARY = ("mean_clip", "opt_apply")


def _row() -> dict:
    return {"device_ms": 0.0, "idle_ms": 0.0, "ops": 0}


def _open_at(spans: list, points: list) -> dict:
    """Each point's open spans on one thread, outermost first. ``spans``
    are (start, end, kind, name, uid) and nest; ``points`` (ts, key)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for ts, key in sorted(points, key=lambda p: p[0]):
        while i < len(spans) and spans[i][0] <= ts:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        out[key] = tuple(s for s in stack if s[1] >= ts)
    return out


def _regions(stack: tuple) -> List[str]:
    return [s[3] for s in stack if s[2] == "region"]


def attribute(trace: dict, steps: int, top: int = 10) -> Optional[dict]:
    """Per-step tables of one profiled stretch of ``steps`` steps, or None
    where it holds no ``dedloc.`` region. ``phases``, ``paths`` (region
    paths joined by ``/``) and ``untraced`` map to ``device_ms``,
    ``idle_ms`` and ``ops`` a step; ``gaps`` holds the ``top`` longest idle
    gaps as [``"<region path> / <host operation>"``, seconds]."""
    events = [e for e in trace["traceEvents"] if isinstance(e, dict)]
    spans: Dict[tuple, list] = {}  # thread -> (start, end, kind, name, uid)
    device, launches, flows = [], {}, {}
    for uid, e in enumerate(events):
        cat, ph = e.get("cat"), e.get("ph")
        if ph == "X" and cat in DEVICE:
            device.append(e)
        elif ph == "X" and cat in LAUNCH:
            launches[e.get("args", {}).get("correlation")] = uid
        elif ph == "X" and cat == "cpu_op":
            name = e["name"]
            kind = ("region" if name.startswith(PREFIX) else
                    "node" if name.startswith(NODE) else "op")
            if kind == "region":
                name = name[len(PREFIX):]
            spans.setdefault(_tid(e), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), kind, name, uid))
        elif ph in ("s", "f") and cat == "fwdbwd":
            flows.setdefault(e.get("id"), {})[ph] = uid
    if not any(s[2] == "region" for ss in spans.values() for s in ss):
        return None

    points: Dict[tuple, list] = {}
    for uid in launches.values():
        points.setdefault(_tid(events[uid]), []).append((events[uid]["ts"], uid))
    flows = {fid: ends for fid, ends in flows.items() if len(ends) == 2}
    for ends in flows.values():
        for uid in ends.values():
            points.setdefault(_tid(events[uid]), []).append((events[uid]["ts"], uid))
    open_at = {}
    for key, ps in points.items():
        open_at.update(_open_at(spans.get(key, []), ps))

    # each backward node's forward operation: its regions, its phase left out
    node_layers: Dict[int, List[str]] = {}
    for ends in flows.values():
        nodes = [s for s in open_at.get(ends["f"], ()) if s[2] == "node"]
        if nodes:
            node_layers[nodes[-1][4]] = _regions(open_at[ends["s"]])[1:]

    # each thread's outermost regions, for the launches of another thread
    tops: Dict[tuple, list] = {}
    for key, ss in spans.items():
        until = None
        for s in sorted(ss, key=lambda s: (s[0], -s[1])):
            if s[2] == "region" and (until is None or s[0] >= until):
                tops.setdefault(key, []).append((s[0], s[1], s[3]))
                until = s[1]
    starts = {key: [t[0] for t in ts] for key, ts in tops.items()}

    def path_of(uid: int) -> tuple:
        """(region path, the outermost host operation under its innermost
        region) of one launch."""
        launch = events[uid]
        ts = launch["ts"]
        stack = open_at.get(uid, ())
        at = max((i for i, s in enumerate(stack) if s[2] == "region"), default=-1)
        node = max((i for i, s in enumerate(stack) if s[2] == "node"), default=-1)
        if node > at:
            path = _regions(stack[:node]) + node_layers.get(stack[node][4], [])
        else:
            path = _regions(stack)
        first = next((s[0] for s in stack if s[2] == "region"), None)
        outer = None
        for key, ts_starts in starts.items():
            i = bisect.bisect_right(ts_starts, ts) - 1
            if key == _tid(launch) or i < 0:
                continue
            start, end, name = tops[key][i]
            if end >= ts and (first is None or start < first) and (
                    outer is None or start < outer[0]):
                outer = (start, name)
        if outer is not None:
            path = [outer[1]] + path
        op = next((s[3] for s in stack[at + 1:] if s[2] != "region"), "")
        return tuple(path), op

    phases: Dict[str, dict] = {}
    paths: Dict[str, dict] = {}
    untraced = _row()
    gaps = []
    covered = None
    for ev in sorted(device, key=lambda e: e["ts"]):
        start, end = ev["ts"], ev["ts"] + ev.get("dur", 0)
        uid = launches.get(ev.get("args", {}).get("correlation"))
        path, op = path_of(uid) if uid is not None else ((), "")
        busy = end - start if covered is None else max(0.0, end - max(start, covered))
        idle = 0.0 if covered is None else max(0.0, start - covered)
        name = "/".join(path)
        rows = ([phases.setdefault(path[0], _row()), paths.setdefault(name, _row())]
                if path else [untraced])
        for row in rows:
            row["device_ms"] += busy * 1e-3
            row["idle_ms"] += idle * 1e-3
            row["ops"] += 1
        if idle > 0:
            gaps.append([(name or "untraced") + (f" / {op}" if op else ""),
                         idle * 1e-6])
        covered = end if covered is None else max(covered, end)
    rows = list(phases.values()) + [untraced]

    def per_step(row: dict) -> dict:
        return {k: v / steps for k, v in row.items()}

    return {
        "steps": steps,
        "busy_ms": sum(r["device_ms"] for r in rows) / steps,
        "idle_ms": sum(r["idle_ms"] for r in rows) / steps,
        "phases": {k: per_step(v) for k, v in phases.items()},
        "paths": {k: per_step(v) for k, v in paths.items()},
        "untraced": per_step(untraced),
        "gaps": sorted(gaps, key=lambda g: -g[1])[:top],
    }


def _tid(event: dict) -> tuple:
    return event.get("pid"), event.get("tid")


# ------------------------------------------------------------- the stretch


def tables(run) -> Optional[dict]:
    """The attribution of the run's program (``attribute``), taken once and
    kept on ``run.regions``."""
    if not hasattr(run, "regions"):
        run.regions = stretch(run)
    return run.regions


def stretch(run) -> Optional[dict]:
    """A second build of the run's program from its seed, warmed by the
    cell's ``warm_steps``, then ``profile_steps`` steps under the profiler
    with the host's activity, attributed; None off the card."""
    ctx = run.cell
    if getattr(ctx, "device", None) != "cuda" or run.profile is None:
        return None
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness
    from portbench.drivers.common import OFF

    cell = ctx.cell
    steps = cell.get("profile_steps", 3)
    driver = harness.load_module(ctx.driver_path,
                                 f"portbench_regions_{ctx.config['driver']}")
    # the window ran under torch's defaults; the reference turned TF32 off
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    program = driver.build(ctx)
    try:
        for _ in range(cell.get("warm_steps", 3)):
            float(program.step(OFF)[0])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            for _ in range(steps):
                loss, _ok = program.step(OFF)
                float(loss)
            wall = time.perf_counter() - w0
        t2 = time.perf_counter()
        trace = harness._export(prof)
        out = attribute(trace, steps)
        t3 = time.perf_counter()
    finally:
        program.close()
        del program
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[portbench] regions: program rebuilt and warmed {t1 - t0:.3f} s; "
        f"{steps} steps traced, {wall / steps * 1e3:.3f} ms a step; trace of "
        f"{len(trace['traceEvents'])} events exported and attributed "
        f"{t3 - t2:.3f} s")
    if out is None:
        log("[portbench] regions: the trace holds no dedloc. region")
        return None
    log(f"[portbench] regions: busy "
        f"{out['busy_ms']:.3f} ms, idle {out['idle_ms']:.3f} ms a step")
    rows = sorted(out["paths"].items(), key=lambda kv: -kv[1]["device_ms"] - kv[1]["idle_ms"])
    for name, row in rows + [("(untraced)", out["untraced"])]:
        log(f"[portbench] region {name}: device {row['device_ms']:.3f} ms, idle "
            f"{row['idle_ms']:.3f} ms, {row['ops']:.1f} ops a step")
    for label, seconds in out["gaps"]:
        log(f"[portbench] region gap {seconds * 1e3:.3f} ms: {label}")
    return out


def phase(run, names, key: str) -> Optional[float]:
    """``key`` a step summed over the phases ``names``, or None without
    tables."""
    t = tables(run)
    if t is None:
        return None
    return sum(t["phases"].get(n, _row())[key] for n in names)
