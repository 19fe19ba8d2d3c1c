"""Start a group of processes as the ranks of one ``torch.distributed``
group (gloo, a ``file://`` rendezvous), as the slice roles run: on the CPU
when asked for, else sharing the card, one process per rank. Used by
``graft_entry``, ``tools/ring_scaling.py`` and the mesh tests' launcher."""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Ranks(NamedTuple):
    """A started group: its processes, their log paths, a name for errors
    and the monotonic deadline set when the group started."""
    procs: List[subprocess.Popen]
    logs: List[str]
    what: str
    deadline: float


def rank_env(rank: int, world: int, rendezvous: str, device_type: str,
             path: Sequence[str] = ()) -> dict:
    """torchrun's environment for one rank, one torch thread, the
    rendezvous file, the repository (and ``path``) on ``PYTHONPATH``, and
    ``DEDLOC_FORCE_CPU=1`` exactly when the ranks run on the CPU."""
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
               DEDLOC_DIST_INIT=f"file://{rendezvous}",
               PYTHONPATH=os.pathsep.join([REPO, *path,
                                           os.environ.get("PYTHONPATH", "")]))
    if device_type == "cpu":
        env["DEDLOC_FORCE_CPU"] = "1"
    else:
        env.pop("DEDLOC_FORCE_CPU", None)
    return env


def start_ranks(argv: Sequence[str], world: int, work: str, name: str,
                device_type: str, timeout: float, cwd: str = REPO,
                path: Sequence[str] = (), env: Optional[Dict[str, str]] = None) -> Ranks:
    """``python <argv>`` as ranks 0..world-1, each logging to
    ``<work>/<name>_rank<r>.log``, with ``env`` over ``rank_env``. The
    group has ``timeout`` seconds from now to end (``wait_ranks``)."""
    procs, logs = [], []
    for rank in range(world):
        log_path = os.path.join(work, f"{name}_rank{rank}.log")
        logs.append(log_path)
        rank_vars = rank_env(rank, world, os.path.join(work, f"{name}_rendezvous"),
                             device_type, path)
        rank_vars.update(env or {})
        with open(log_path, "w") as log:
            procs.append(subprocess.Popen([sys.executable, *argv], env=rank_vars,
                                          stdout=log, stderr=subprocess.STDOUT, cwd=cwd))
    return Ranks(procs, logs, name, time.monotonic() + timeout)


def wait_ranks(*groups: Ranks) -> List[str]:
    """Wait for every process of ``groups``; returns each one's log, in
    order. A process still running at its group's deadline kills them all
    and raises with each one's log tail, as does a nonzero exit."""
    running = [(p, g.deadline) for g in groups for p in g.procs]
    try:
        for p, deadline in running:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p, _ in running if p.poll() is None]
        for p in hung:
            p.kill()
        for p, _ in running:
            p.wait()
    texts, tails = [], []
    for g in groups:
        for rank, (p, path) in enumerate(zip(g.procs, g.logs)):
            with open(path, errors="replace") as f:
                texts.append(f.read())
            tails.append(f"--- {g.what} rank {rank} (rc {p.returncode}) ---\n"
                         f"{texts[-1][-4000:]}")
    if hung or any(p.returncode for p, _ in running):
        names = ", ".join(g.what for g in groups)
        state = f"{len(hung)} rank(s) hung, killed" if hung else "a rank failed"
        raise RuntimeError(f"{names}: {state}\n" + "\n".join(tails))
    return texts
