"""Readings for the limits of ``correct``, outside the benchmark's runs.

For one cell and each seed given, in one process, through the same
``harness.first_steps`` and ``harness.against_reference`` that a run
takes them by: the program's first steps, then the plain reference in
float32, and against that reference the numbers that

- the program gives (the lower readings);
- the control gives: the reference put in the program's place in
  bfloat16 throughout (parameters, activations, normalisations, optimizer
  state and update), the nearest precision below the float32 that the
  configuration states for them (``--control``);
- the half-batch fault gives: the reference in the program's place with
  half of each step's samples left out, the mean taken over the rest
  (``--half``);
- a wrong update gives: the reference in the program's place with each
  update added with the wrong sign (``--flip``).

A state left unchanged reads 1 on ``change_gap`` by the comparison's
measure and needs no run. One JSON line per seed and reading goes to
standard output.

    python3 portbench/check.py --workload albert-large.s512 --seeds 1,2,3 --control --half --flip
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true")
    p.add_argument("--half", action="store_true")
    p.add_argument("--flip", action="store_true")
    p.add_argument("--control-seeds", type=int, default=3,
                   help="run the control and the faults on the first N seeds")
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=str(ROOT), help="the checkout")
    p.add_argument("--program", default="{}",
                   help="JSON settings merged into the cell's program settings "
                        "(a witness: another path of the program)")
    p.add_argument("--label", default="program")
    args = p.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.reference import compare

    ctx = harness.resolve(args.workload, Path(args.root))
    ctx.device = args.device
    ctx.cell["program"] = {**ctx.cell["program"], **json.loads(args.program)}
    driver = harness.load_module(ctx.driver_path, "portbench_driver")
    faults = [(label, kw) for on, label, kw in (
        (args.control, "control_bf16", dict(dtype=torch.bfloat16)),
        (args.half, "half_batch", dict(half=True)),
        (args.flip, "update_flipped", dict(flip=True))) if on]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        ctx.seed = seed
        t0 = time.perf_counter()
        program, readings = harness.first_steps(ctx, driver)
        program.close()
        del program
        program_s = time.perf_counter() - t0
        numbers, ref, ref_s = harness.against_reference(ctx, driver, readings)
        _emit(args.workload, seed, args.label, numbers,
              program_s=program_s, reference_s=ref_s)
        for label, kw in faults if i < args.control_seeds else ():
            t1 = time.perf_counter()
            try:
                got = driver.reference(ctx, ctx.cell["reference_steps"], **kw)
                row = compare.gaps(got, ref)
            except Exception as e:  # noqa: BLE001 — a control that crashes has failed
                row = {"error": repr(e)[:300]}
            _emit(args.workload, seed, label, row, seconds=time.perf_counter() - t1)
            gc.collect()
            if ctx.device == "cuda":
                torch.cuda.empty_cache()
    return 0


def _emit(workload: str, seed: int, reading: str, numbers: dict, **extra) -> None:
    print(json.dumps({"workload": workload, "seed": seed, "reading": reading,
                      **extra, **numbers}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
