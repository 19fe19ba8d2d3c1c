"""Run a function of ``tests/torch_mesh_cases.py`` on N gloo ranks of a
slice mesh on the CPU, each rank its own process, and bring back what each
rank returns.

Rules the mesh tests keep, so that they stay cheap beside the rest of the
suite: at most 4 ranks, one torch thread per rank, a ``file://``
rendezvous under the test's ``tmp_path`` (no TCP port), and a join
timeout that kills the whole group and fails the test with the ranks'
logs, so a hung collective cannot run into the suite's time limit.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MAX_RANKS = 4


def run_ranks(tmp_path, world: int, case: str, inputs=None, timeout: float = 120.0,
              env=None):
    """``case(rank, world, inputs) -> object`` of ``torch_mesh_cases`` on
    ``world`` ranks; returns the list of each rank's result."""
    if not 1 <= world <= MAX_RANKS:
        raise ValueError(f"{world} ranks: the mesh tests use at most {MAX_RANKS}")
    work = os.path.join(str(tmp_path), f"ranks_{case}_{time.monotonic_ns()}")
    os.makedirs(work)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    procs, logs = [], []
    for rank in range(world):
        e = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                 LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                 DEDLOC_DIST_INIT=f"file://{work}/rendezvous",
                 DEDLOC_FORCE_CPU="1",
                 PYTHONPATH=os.pathsep.join([REPO, HERE,
                                             os.environ.get("PYTHONPATH", "")]))
        e.update(env or {})
        log = open(os.path.join(work, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "torch_mesh_ranks", case, work],
            env=e, stdout=log, stderr=subprocess.STDOUT, cwd=HERE))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    tails = "\n".join(
        f"--- rank {r} (rc {p.returncode}) ---\n" + _tail(work, r)
        for r, p in enumerate(procs))
    if hung:
        raise AssertionError(f"{case}: {len(hung)} rank(s) still running after "
                             f"{timeout:.0f} s, killed\n{tails}")
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{case}: a rank failed\n{tails}")
    out = []
    for rank in range(world):
        with open(os.path.join(work, f"out{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))  # written by the rank above
    return out


def run_slice_cli(work: str, world: int, argv, timeout: float = 120.0,
                  name: str = "slice", wait: bool = True):
    """The trainer CLI (``python -m dedloc_tpu_torch.roles.trainer``) as a
    slice of ``world`` CPU ranks, each its own process with torchrun's
    environment and a ``file://`` rendezvous. With ``wait`` returns each
    rank's log once all exit 0 (a hang past ``timeout`` kills them and
    fails); else the running processes (``wait_slice`` finishes them)."""
    if not 1 <= world <= MAX_RANKS:
        raise ValueError(f"{world} ranks: the mesh tests use at most {MAX_RANKS}")
    os.makedirs(work, exist_ok=True)
    procs = []
    for rank in range(world):
        e = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                 LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                 DEDLOC_DIST_INIT=f"file://{work}/{name}_rendezvous",
                 DEDLOC_FORCE_CPU="1",
                 PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        log = open(os.path.join(work, f"{name}_rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "dedloc_tpu_torch.roles.trainer", *argv],
            env=e, stdout=log, stderr=subprocess.STDOUT, cwd=REPO), log))
    running = (work, name, procs, time.monotonic() + timeout)
    return wait_slice(running) if wait else running


def wait_slice(running):
    work, name, procs, deadline = running
    try:
        for p, _log in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p, _ in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for p, log in procs:
            p.wait()
            log.close()
    logs = []
    for rank in range(len(procs)):
        with open(os.path.join(work, f"{name}_rank{rank}.log")) as f:
            logs.append(f.read())
    tails = "\n".join(f"--- {name} rank {r} (rc {p.returncode}) ---\n{log[-4000:]}"
                      for r, ((p, _), log) in enumerate(zip(procs, logs)))
    if hung:
        raise AssertionError(f"{name}: {len(hung)} rank(s) hung, killed\n{tails}")
    if any(p.returncode != 0 for p, _ in procs):
        raise AssertionError(f"{name}: a rank failed\n{tails}")
    return logs


def _tail(work: str, rank: int, n: int = 4000) -> str:
    with open(os.path.join(work, f"rank{rank}.log")) as f:
        return f.read()[-n:]


def main(argv) -> None:
    case, work = argv
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import torch_mesh_cases
    from dedloc_tpu_torch.parallel.mesh import init_slice

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    init_slice(world, "cpu")
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)  # written by run_ranks
    result = getattr(torch_mesh_cases, case)(rank, world, inputs)
    with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
