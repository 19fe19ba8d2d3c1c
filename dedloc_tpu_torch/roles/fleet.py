"""Local fleet driver: coordinator + trainer + aux peers with bandwidth
tiers and spot-preemption churn.

Capability parity with the reference's AWS fleet notebook
(albert/AWS_runner.ipynb: coordinator r5.large + aux CPU peers + preemptible
g4dn spot workers, per-peer wondershaper bandwidth throttling in cell 2, and
a respawn loop for terminated spot instances in the last cell) — as an
in-framework, scriptable harness instead of cloud-specific operations:

- every peer is a subprocess running the real role entry points
  (``python -m dedloc_tpu_torch.roles.{coordinator,trainer,aux}``) on localhost,
  the trainers on the card unless the caller sets DEDLOC_FORCE_CPU=1, the
  coordinator and aux peers with CUDA hidden (they hold no device tensor);
- bandwidth tiers cycle over trainers and flow into the averager's
  bandwidth-weighted partitioning (the advertised-throughput capability of
  ``throughput=bandwidth``, albert/run_trainer.py:258);
- churn injection SIGKILLs a random trainer every ``churn_interval`` seconds
  (spot "terminate" semantics, InstanceInterruptionBehavior) and respawns it
  after ``respawn_delay`` — the respawned peer rejoins via the DHT and pulls
  state from peers, exercising the elasticity path end-to-end.

This doubles as the fault-injection harness SURVEY.md §4 calls the biggest
testing gap: deterministic preemption under a live collaboration. A
``testing.faults.FaultSchedule`` makes the churn fully scripted: victim
selection draws from the schedule's seeded RNG (one seed replays the whole
scenario) and an injected ``fleet.preempt`` fault with a ``target`` names
the exact trainer to kill — so "kill trainer1 on the third churn tick" is a
reproducible test, not a soak.
"""
from __future__ import annotations

import os
import random
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dedloc_tpu_torch.core import timeutils
from dedloc_tpu_torch.core.config import parse_config
from dedloc_tpu_torch.core.timeutils import get_dht_time
from dedloc_tpu_torch.testing.faults import FaultSchedule
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class FleetArguments:
    num_trainers: int = 4
    num_aux: int = 0
    # advertised Mbps per trainer, cycled (AWS notebook tiers 200/100/50)
    bandwidth_tiers: List[float] = field(
        default_factory=lambda: [200.0, 100.0, 100.0, 50.0]
    )
    churn_interval: float = 0.0  # seconds between preemptions (0 = off)
    respawn_delay: float = 1.0
    duration: float = 60.0  # wall-clock seconds (0 = until interrupted)
    experiment_prefix: str = "fleet"
    target_batch_size: int = 64
    model_size: str = "tiny"
    per_device_batch_size: int = 2
    gradient_accumulation_steps: int = 2
    output_dir: str = "fleet_out"
    coordinator_refresh_period: float = 2.0
    seed: int = 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LocalFleet:
    """Process-supervisor for one local collaboration."""

    def __init__(self, args: FleetArguments, extra_trainer_flags:
                 Optional[List[str]] = None,
                 fault_schedule: Optional[FaultSchedule] = None):
        self.args = args
        self.extra_trainer_flags = list(extra_trainer_flags or [])
        self.root_port = _free_port()
        self.root_addr = f"127.0.0.1:{self.root_port}"
        self.procs: Dict[str, subprocess.Popen] = {}
        self.events: List[Dict] = []  # spawn/preempt/respawn log
        # deterministic churn: with a FaultSchedule attached, victim choice
        # draws from ITS seeded RNG (one seed replays the scenario) and
        # injected "fleet.preempt" faults can script exact victims
        self.faults = fault_schedule
        self._rng = (
            fault_schedule.rng if fault_schedule is not None
            else random.Random(args.seed)
        )
        self._harness_killed: set = set()  # pids WE killed (vs external death)
        self._crash_counts: Dict[str, int] = {}
        self.max_crash_respawns = 5  # per-peer cap on crash-loop restarts
        os.makedirs(args.output_dir, exist_ok=True)

    # ------------------------------------------------------------- spawning

    def _spawn(self, name: str, module: str, flags: List[str]) -> None:
        env = dict(os.environ)
        if not module.endswith(".trainer"):
            env["CUDA_VISIBLE_DEVICES"] = ""
        # the child duplicates the descriptor; close the parent's handle so
        # churn respawns don't leak one fd per spawn
        with open(os.path.join(self.args.output_dir, f"{name}.log"), "ab") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", module, *flags],
                env=env, stdout=log, stderr=subprocess.STDOUT,
            )
        self.procs[name] = proc
        self.events.append(
            {"t": get_dht_time(), "event": "spawn", "peer": name}
        )
        logger.info(f"spawned {name} (pid {proc.pid})")

    def _common_flags(self, initial_peers: bool = True) -> List[str]:
        a = self.args
        flags = [
            "--dht.experiment_prefix", a.experiment_prefix,
            "--dht.listen_host", "127.0.0.1",
            "--averager.averaging_expiration", "1.0",
            "--averager.min_refresh_period", "0.1",
            "--averager.default_refresh_period", "0.5",
            "--optimizer.target_batch_size", str(a.target_batch_size),
        ]
        if initial_peers:
            flags += ["--dht.initial_peers", self.root_addr]
        return flags

    def start_coordinator(self) -> None:
        a = self.args
        self._spawn(
            "coordinator",
            "dedloc_tpu_torch.roles.coordinator",
            self._common_flags(initial_peers=False) + [
                "--dht.listen_port", str(self.root_port),
                "--coordinator.refresh_period",
                str(a.coordinator_refresh_period),
                "--coordinator.metrics_log_path",
                os.path.join(a.output_dir, "coordinator_metrics.jsonl"),
                "--coordinator.ledger_log_path",
                os.path.join(a.output_dir, "coordinator_ledger.jsonl"),
            ],
        )

    def start_trainer(self, idx: int) -> None:
        a = self.args
        tier = a.bandwidth_tiers[idx % len(a.bandwidth_tiers)]
        self._spawn(
            f"trainer{idx}",
            "dedloc_tpu_torch.roles.trainer",
            self._common_flags() + [
                "--averager.bandwidth", str(tier),
                "--training.model_size", a.model_size,
                "--training.seq_length", "64",
                "--training.per_device_batch_size",
                str(a.per_device_batch_size),
                "--training.gradient_accumulation_steps",
                str(a.gradient_accumulation_steps),
                "--training.seed", str(a.seed + idx),
                "--training.save_steps", "0",
                "--training.output_dir",
                os.path.join(a.output_dir, f"trainer{idx}"),
                *self.extra_trainer_flags,
            ],
        )

    def start_aux(self, idx: int) -> None:
        self._spawn(
            f"aux{idx}",
            "dedloc_tpu_torch.roles.aux",
            self._common_flags() + ["--training.model_size",
                                    self.args.model_size],
        )

    def start(self) -> None:
        self.start_coordinator()
        time.sleep(1.0)  # let the DHT root come up before peers bootstrap
        for i in range(self.args.num_trainers):
            self.start_trainer(i)
        for i in range(self.args.num_aux):
            self.start_aux(i)

    # ---------------------------------------------------------------- churn

    def preempt_random_trainer(self) -> Optional[str]:
        """Spot-terminate semantics: SIGKILL, no graceful shutdown."""
        alive = [
            n for n, p in self.procs.items()
            if n.startswith("trainer") and p.poll() is None
        ]
        if not alive:
            return None
        victim = None
        if self.faults is not None:
            fault = self.faults.fire("fleet.preempt", alive=alive)
            if fault is not None and fault.target in alive:
                victim = fault.target  # scripted kill
        if victim is None:
            victim = self._rng.choice(alive)
        self._harness_killed.add(self.procs[victim].pid)
        self.procs[victim].kill()
        self.procs[victim].wait()
        self.events.append(
            {"t": get_dht_time(), "event": "preempt", "peer": victim}
        )
        logger.info(f"preempted {victim}")
        return victim

    def respawn(self, name: str) -> None:
        idx = int(name.removeprefix("trainer"))
        self.start_trainer(idx)
        self.events[-1]["event"] = "respawn"

    def run(self) -> None:
        """Supervise until ``duration`` elapses; churn + respawn throughout
        (the notebook's spot-respawn loop)."""
        a = self.args
        deadline = (
            timeutils.monotonic() + a.duration if a.duration else None
        )
        next_churn = (
            timeutils.monotonic() + a.churn_interval
            if a.churn_interval else None
        )
        pending_respawn: List[tuple] = []  # (respawn_at, name)
        try:
            while deadline is None or timeutils.monotonic() < deadline:
                time.sleep(0.2)
                now = timeutils.monotonic()
                if next_churn is not None and now >= next_churn:
                    victim = self.preempt_random_trainer()
                    if victim is not None:
                        pending_respawn.append(
                            (now + a.respawn_delay, victim)
                        )
                    next_churn = now + a.churn_interval
                for at, name in list(pending_respawn):
                    if now >= at:
                        pending_respawn.remove((at, name))
                        self.respawn(name)
                # respawn trainers that died EXTERNALLY (OOM kill, crash) —
                # identified by pid bookkeeping, not signal numbers, so a
                # kill -9 from outside still gets a respawn while our own
                # churn preemptions (already queued above) don't double up.
                # Clean exits (returncode 0, e.g. max_local_steps reached)
                # stay down; crash loops are capped with linear backoff.
                for name, proc in list(self.procs.items()):
                    if (
                        name.startswith("trainer")
                        and proc.poll() is not None
                        and proc.pid not in self._harness_killed
                        and proc.returncode != 0
                        and not any(n == name for _, n in pending_respawn)
                    ):
                        crashes = self._crash_counts.get(name, 0) + 1
                        self._crash_counts[name] = crashes
                        self.events.append(
                            {"t": get_dht_time(), "event": "died",
                             "peer": name, "returncode": proc.returncode}
                        )
                        if crashes > self.max_crash_respawns:
                            logger.warning(
                                f"{name} crashed {crashes} times; giving up"
                            )
                            del self.procs[name]
                            continue
                        pending_respawn.append(
                            (now + a.respawn_delay * crashes, name)
                        )
        finally:
            self.stop()

    def stop(self) -> None:
        for name, proc in self.procs.items():
            if proc.poll() is None:
                proc.terminate()
        for name, proc in self.procs.items():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        logger.info(f"fleet stopped ({len(self.events)} lifecycle events)")


def run_fleet(args: FleetArguments,
              extra_trainer_flags: Optional[List[str]] = None) -> LocalFleet:
    fleet = LocalFleet(args, extra_trainer_flags)
    fleet.start()
    fleet.run()
    return fleet


def main(argv=None) -> None:
    run_fleet(parse_config(FleetArguments, argv))


if __name__ == "__main__":
    main()
