"""One run of one cell: set-up, a timed window, an optional profiled
stretch, the comparison with the plain reference, one result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``portbench/workloads/<cell>.json``: the configuration and traffic it
  names, the program's settings, the steps the reference follows and the
  limits of the numbers compared;
- ``portbench/configs/<config>.json``: the sizes, precisions and optimizer
  of the model, and its ``driver``, ``portbench/drivers/<driver>.py``
  (``build(ctx)`` gives the program's step, ``reference(ctx, steps)`` the
  plain reference's readings);
- ``portbench/traffic/<traffic>.json``: the micro-batch, sequence length,
  accumulation and pool size that its ``generator``,
  ``portbench/traffic/<generator>.py``, reads;
- ``portbench/metrics/<metric>.py``: ``read(run)`` gives a per-layer
  metric from the run's spans, counts and trace, or None. A metric split
  by the end-to-end metric it moves (``<metric>.<part>``) is read by
  ``<metric>.py`` where it has no reader of its own; an end-to-end metric
  so split is the quantity its first part names.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dedloc_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from its file, registered under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(name: str, root: Path = ROOT) -> types.SimpleNamespace:
    """Everything one cell of ``BENCHMARK.json`` names, read from its files."""
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    base = root / "portbench"
    cell = load_json(base / "workloads" / f"{name}.json")
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{name}: the cell's file and BENCHMARK.json disagree")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
    applies = lambda m: name in m.get("workloads", [name])
    return types.SimpleNamespace(
        name=name, bench=bench, entry=entry, cell=cell, config=config,
        traffic=traffic, root=root,
        driver_path=base / "drivers" / f"{config['driver']}.py",
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        reader_paths={m["name"]: reader_path(base / "metrics", m["name"])
                      for m in bench["per_layer"] if applies(m)})


def reader_path(metrics: Path, name: str) -> Path:
    """``<name>.py``, or where there is none, the reader of the part of
    ``name`` before its first dot."""
    own = metrics / f"{name}.py"
    return own if own.exists() else metrics / f"{name.split('.')[0]}.py"


def _smi() -> Dict[str, str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, power, mhz = (s.strip() for s in out.split(","))
    return {"name": name, "power_limit": power, "max_sm_mhz": mhz}


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (compared whole: ``dedloc_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ------------------------------------------------------------------ trace


def _device_events(trace: dict) -> list:
    return [e for e in trace["traceEvents"]
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _union(intervals) -> List[List[float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _export(prof) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def profile_steps(program, steps: int, sync: Callable[[], None]) -> dict:
    """``steps`` whole steps under ``torch.profiler`` (device activity
    only): every device operation, the host wall time over them, and the
    busy time (the union of kernel, memcpy and memset intervals)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.drivers.common import OFF

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, _ok = program.step(OFF)
            float(loss)
        wall = time.perf_counter() - t0
    events = _device_events(_export(prof))
    if not events:
        raise RuntimeError("the profiler saw no device activity")
    busy_us = sum(e - s for s, e in _union((ev["ts"], ev["ts"] + ev["dur"])
                                           for ev in events))
    by_name: Dict[str, float] = {}
    for ev in events:
        by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ev["dur"] * 1e-6
    return {"events": events, "steps": steps, "wall_s": wall,
            "busy_s": busy_us * 1e-6, "by_name": by_name}


def idle_gaps(program, sync: Callable[[], None], top: int = 10) -> list:
    """One step under the profiler with the host's activity too: the
    longest gaps between device operations, each named by the benchmark's
    span and the outermost host operation running at its middle."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.drivers.common import Spans

    spans = Spans(labels=True)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.step"):
            loss, _ok = program.step(spans)
            with record_function("portbench.sync"):
                float(loss)
    trace = _export(prof)
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in _device_events(trace))
    host = [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")]
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    out = []
    for start, end in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (start + end) / 2
        around = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        marks = [e for e in around if e["name"].startswith("portbench.")]
        ops = [e for e in around if e.get("cat") == "cpu_op"]
        label = (max(marks, key=lambda e: e["ts"])["name"] if marks else "outside")
        if ops:
            label += " / " + min(ops, key=lambda e: e["ts"])["name"]
        out.append([label, (end - start) * 1e-6])
    return out


# ------------------------------------------------------------ readings


def first_steps(ctx, driver):
    """The program built from the seed and driven through its first steps
    by its own step call: (the program, ready for the window; its readings
    after the steps the reference follows)."""
    from portbench.drivers.common import prime

    program = driver.build(ctx)
    cell = ctx.cell
    return program, prime(program, cell["reference_steps"], cell.get("warm_steps", 3))


def against_reference(ctx, driver, readings: dict) -> tuple:
    """Once the program's state is freed: the plain reference over the same
    steps in float32 with TF32 off, and the numbers that compare
    ``readings`` with it. Returns (numbers, the reference's readings,
    seconds)."""
    import torch

    from portbench.reference import compare

    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ref = driver.reference(ctx, ctx.cell["reference_steps"])
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    return compare.gaps(readings, ref), ref, time.perf_counter() - t0


# -------------------------------------------------------------------- run


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", root: Path = ROOT) -> Optional[dict]:
    """One run of cell ``name``; returns the result line's object, or None
    when the run must print none."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(root / "dedloc_tpu_torch" / "build" / "triton"))
    import torch

    from portbench.counts import h100
    from portbench.drivers.common import Spans
    from portbench.reference import compare

    ctx = resolve(name, root)
    ctx.seed, ctx.device = seed, device
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = {}
    if on_card:
        smi = _smi()
        props = torch.cuda.get_device_properties(0)
        card = {"kind": torch.cuda.get_device_name(0), "smi": smi,
                "exp_per_s": h100.exp_per_s(props.multi_processor_count,
                                            float(smi["max_sm_mhz"].split()[0]))}
        log(f"[portbench] {card['kind']} | nvidia-smi: {smi['name']}, power limit "
            f"{smi['power_limit']}, max SM clock {smi['max_sm_mhz']} | "
            f"{props.multi_processor_count} SMs | torch {torch.__version__} "
            f"cuda {torch.version.cuda}")
        torch.cuda.reset_peak_memory_stats()
    driver = load_module(ctx.driver_path, f"portbench_driver_{ctx.config['driver']}")
    t_built = time.perf_counter()
    program, readings = first_steps(ctx, driver)
    sync()
    cell = ctx.cell
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] set-up: imports and device {t_built - t_start:.3f} s, program "
        f"built (weights, optimizer, pool of {ctx.traffic['pool']}) and its first "
        f"{max(cell['reference_steps'], cell.get('warm_steps', 3))} steps "
        f"{setup_s - (t_built - t_start):.3f} s")
    log(f"[portbench] {name} seed {seed}: set-up {setup_s:.3f} s, readings after "
        f"{cell['reference_steps']} steps taken")

    spans = Spans(on=trace, sync=sync)
    step_s, oks, losses = [], [], []
    w0 = time.perf_counter()
    while True:
        s0 = time.perf_counter()
        loss, ok = program.step(spans)
        losses.append(float(loss))  # the trainer's one host read a step
        step_s.append(time.perf_counter() - s0)
        oks.append(ok)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    failed = int((~torch.stack([torch.as_tensor(o) for o in oks])).sum())
    log(f"[portbench] window: {len(step_s)} steps in {window_s:.3f} s; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {failed} applies rolled back")
    profiled, gaps = None, None
    if trace:
        profiled = profile_steps(program, cell.get("profile_steps", 3), sync)
        gaps = idle_gaps(program, sync) if on_card else []
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    shapes = program.kernel_shapes
    samples, flops = program.samples_per_step, program.flops_per_step
    program.close()
    del program

    numbers, ref, ref_s = against_reference(ctx, driver, readings)
    limits = cell["limits"]
    finite = all(math.isfinite(x) for x in readings["losses"] + losses)
    correct = bool(finite and compare.judge(numbers, limits))
    log(f"[portbench] reference: {ref_s:.3f} s; program losses {readings['losses']}, "
        f"reference {ref['losses']}; worst leaves: sum {numbers['sum_gap_leaf']}, "
        f"gradient {numbers['grad_gap_leaf']}, change {numbers['change_gap_leaf']}, "
        f"change's direction {numbers['change_diff_leaf']}; left out of the change "
        f"as quiet: {numbers['quiet_leaves']}")

    run_info = types.SimpleNamespace(
        window_s=window_s, steps=len(step_s), step_s=step_s,
        samples_per_step=samples, flops_per_step=flops, spans=spans.totals,
        span_counts=spans.counts, profile=profiled, shapes=shapes,
        exp_per_s=card.get("exp_per_s", 0.0), cell=ctx)
    metrics = {}
    if not trace:
        e2e = {
            "samples_per_s": len(step_s) * samples / window_s,
            "step_ms_p90": statistics.quantiles([s * 1e3 for s in step_s], n=10)[8]
            if len(step_s) >= 2 else step_s[0] * 1e3,
            "peak_mem_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
        for m in ctx.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    else:
        for m in ctx.per_layer:
            reader = load_module(ctx.reader_paths[m["name"]],
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(run_info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(step_s), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": card.get("kind", "cpu"), "count": 1,
                         "memory_peak_bytes": peak}}
    if trace and profiled is not None:
        result["device"]["busy_s"] = profiled["busy_s"]
        result["device"]["window_s"] = profiled["wall_s"]
        top = sorted(profiled["by_name"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:120], s] for n, s in top],
                               "idle_gaps": gaps}
    result["compared"] = {k: {"value": numbers[k], "limit": v}
                          for k, v in limits.items()}
    found = forbidden_modules()
    if found:
        log(f"[portbench] forbidden modules loaded: {found}")
        return None
    for k, v in limits.items():
        log(f"compared {k} {numbers[k]!r} limit {v!r}")
    return result
