"""Two real trainer peers of one package with overlap averaging
(``--optimizer.overlap_averaging``), each a process started through the
package's CLI (``python -m dedloc_tpu.roles.trainer`` or ``python -m
dedloc_tpu_torch.roles.trainer``), tiny model on the CPU, every global
step checkpointed; then their states compared at every common step. Used
by ``tests/test_torch_overlap_peers.py``, and as a script to compare the
two packages the same way at a small target, with one peer started late:

    python tests/torch_mesh_overlap_peers.py --reps 3 --delay 3 --expiration 1 --slices

prints one JSON line per run: each peer's group size per applied step, the
steps whose states hash equal or differ, and whether every difference
follows a step one peer took alone (group 1) that the other did not.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
APPLIED = re.compile(r"global step (\d+) applied \(group=(\d+)")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def flags(target: int, boundaries: int, slices: bool, expiration: float = 3.0) -> list:
    """The peers' shared flags: 24 samples a boundary (12 x 2 on one
    device, 6 x 2 x 2 on a 2-rank slice), the tiny model at S=32."""
    return ["--dht.experiment_prefix", "overlap-peers", "--dht.listen_host", "127.0.0.1",
            "--training.model_size", "tiny", "--training.seq_length", "32",
            "--training.per_device_batch_size", "6" if slices else "12",
            "--training.gradient_accumulation_steps", "2",
            *(["--training.mesh_devices", "2"] if slices else []),
            "--training.max_local_steps", str(boundaries),
            "--training.save_steps", "1", "--training.save_total_limit", "0",
            "--training.warmup_steps", "0", "--training.seed", "0",
            "--averager.averaging_expiration", str(expiration),
            "--optimizer.target_batch_size", str(target),
            "--optimizer.overlap_averaging", "true",
            "--averager.compression", "float16",
            "--averager.min_refresh_period", "0.2",
            "--averager.default_refresh_period", "0.5"]


def run_pair(package: str, work: str, target: int = 48, steps: int = 4,
             delay_b: float = 0.0, slices: bool = False, timeout: float = 120,
             expiration: float = 3.0) -> dict:
    """Peers A and B of ``package`` ("dedloc_tpu" or "dedloc_tpu_torch"),
    each bootstrapping from the other, B started ``delay_b`` s after A;
    stopped (SIGTERM) once each has applied ``steps`` global steps, or
    after ``timeout`` s. A boundary takes ~10 ms in a JAX peer and ~50 ms
    in the port's on an idle CPU, many times that on a loaded one: the
    run is bounded by steps, not boundaries."""
    ports = {"A": _port(), "B": _port()}
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", DEDLOC_FORCE_CPU="1",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = {}
    for peer, other in (("A", "B"), ("B", "A")):
        if peer == "B" and delay_b:
            time.sleep(delay_b)
        pdir = os.path.join(work, peer)
        os.makedirs(pdir)
        if package == "dedloc_tpu_torch" and slices:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", "2", "-m", "dedloc_tpu_torch.roles.trainer"]
        else:
            cmd = [sys.executable, "-m", f"{package}.roles.trainer"]
        cmd += flags(target, 100000, slices, expiration) + [
            "--dht.listen_port", str(ports[peer]),
            "--dht.initial_peers", f"127.0.0.1:{ports[other]}",
            "--training.output_dir", pdir]
        with open(os.path.join(pdir, "log.txt"), "w") as log:
            procs[peer] = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log,
                                           stderr=subprocess.STDOUT)
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            applied = [len(_peer(os.path.join(work, p), None)["groups"]) for p in procs]
            if min(applied) >= steps or any(pr.poll() is not None for pr in procs.values()):
                break
            time.sleep(0.5)
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.terminate()
        for pr in procs.values():
            try:
                pr.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()
    return {peer: _peer(os.path.join(work, peer), p.returncode)
            for peer, p in procs.items()}


def _peer(pdir: str, rc: int) -> dict:
    with open(os.path.join(pdir, "log.txt"), errors="replace") as f:
        text = f.read()
    groups = {}
    for m in APPLIED.finditer(text):
        groups[int(m.group(1))] = int(m.group(2))
    ckpts = {int(n.split("-")[1]): os.path.join(pdir, n) for n in os.listdir(pdir)
             if n.startswith("checkpoint-") and not n.endswith(".tmp")}
    return {"rc": rc, "groups": groups, "checkpoints": ckpts, "log_tail": text[-2000:]}


def state_hash(path: str) -> str:
    sys.path.insert(0, REPO)
    from dedloc_tpu_torch.utils.checkpoint import load_checkpoint

    named, _meta = load_checkpoint(path)
    h = hashlib.sha256()
    for name in sorted(named):
        h.update(name.encode())
        h.update(np.ascontiguousarray(named[name]).tobytes())
    return h.hexdigest()


def compare(run: dict) -> dict:
    """The states at every common checkpointed step; a step counts as
    ``checked`` when neither peer took a step alone (group 1) up to it, so
    both applied the same rounds and must hold the same bytes."""
    a, b = run["A"], run["B"]
    solo = {p: sorted(s for s, g in run[p]["groups"].items() if g == 1) for p in run}
    common = sorted(set(a["checkpoints"]) & set(b["checkpoints"]))
    equal = {s: state_hash(a["checkpoints"][s]) == state_hash(b["checkpoints"][s])
             for s in common}
    checked = [s for s in common
               if not any(x <= s for p in solo for x in solo[p])]
    return {"groups": {p: run[p]["groups"] for p in run}, "solo": solo,
            "equal": equal, "checked": checked,
            "checked_equal": all(equal[s] for s in checked),
            "every_difference_follows_a_solo_step": all(
                any(x <= s for p in solo for x in solo[p])
                for s, same in equal.items() if not same)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", default="dedloc_tpu,dedloc_tpu_torch")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--delay", type=float, default=0.0)
    ap.add_argument("--target", type=int, default=48)
    ap.add_argument("--slices", action="store_true")
    ap.add_argument("--expiration", type=float, default=3.0,
                    help="--averager.averaging_expiration (the matchmaking window)")
    ap.add_argument("--steps", type=int, default=6,
                    help="global steps each peer applies before both stop")
    args = ap.parse_args(argv)
    for rep in range(args.reps):
        for package in args.packages.split(","):
            with tempfile.TemporaryDirectory(prefix="overlap_peers_") as work:
                run = run_pair(package, work, args.target, args.steps,
                               args.delay, args.slices, expiration=args.expiration)
                out = compare(run)
                print(json.dumps({"package": package, "rep": rep, "delay_b": args.delay,
                                  "expiration": args.expiration,
                                  "slices": args.slices, "target": args.target,
                                  "rc": {p: run[p]["rc"] for p in run}, **out},
                                 default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
