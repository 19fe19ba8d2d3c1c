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
import sys
import time

from dedloc_tpu_torch.tools.ranks import start_ranks, wait_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
MAX_RANKS = 4


def _check_world(world: int) -> None:
    if not 1 <= world <= MAX_RANKS:
        raise ValueError(f"{world} ranks: the mesh tests use at most {MAX_RANKS}")


def run_ranks(tmp_path, world: int, case: str, inputs=None, timeout: float = 120.0,
              env=None):
    """``case(rank, world, inputs) -> object`` of ``torch_mesh_cases`` on
    ``world`` ranks; returns the list of each rank's result."""
    _check_world(world)
    work = os.path.join(str(tmp_path), f"ranks_{case}_{time.monotonic_ns()}")
    os.makedirs(work)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    wait_ranks(start_ranks(["-m", "torch_mesh_ranks", case, work], world, work,
                           case, "cpu", timeout, cwd=HERE, path=(HERE,), env=env))
    out = []
    for rank in range(world):
        with open(os.path.join(work, f"out{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))  # written by the rank in main
    return out


def run_slice_cli(work: str, world: int, argv, timeout: float = 120.0,
                  name: str = "slice", wait: bool = True,
                  module: str = "dedloc_tpu_torch.roles.trainer"):
    """A role's CLI (``python -m <module>``, the trainer by default) as a
    slice of ``world`` CPU ranks. With ``wait`` returns each rank's log
    once all exit 0 (a hang past ``timeout`` kills them and fails); else
    the running group (``wait_slice`` finishes it)."""
    _check_world(world)
    os.makedirs(work, exist_ok=True)
    running = start_ranks(["-m", module, *argv], world, work, name, "cpu", timeout)
    return wait_slice(running) if wait else running


#: finishes a ``run_slice_cli(..., wait=False)`` group, returning its logs
wait_slice = wait_ranks


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
