"""Cloud fleet provisioning: the real-cloud counterpart of ``roles/fleet.py``.

Capability parity with the reference's AWS fleet notebook
(albert/AWS_runner.ipynb): a coordinator VM + auxiliary CPU peers +
preemptible accelerator workers, per-peer bandwidth shaping (the notebook
throttles with wondershaper in each instance's user-data; here the startup
script uses ``tc``), and a respawn supervisor that recreates terminated spot
instances (the notebook's last cell) — but as a scriptable, provider-seamed
module instead of a notebook:

- ``CloudFleetSpec`` describes the fleet (counts, machine/accelerator types,
  bandwidth tiers, the run's DHT/auth coordinates).
- ``Provider`` is the seam: ``GceGpuProvider`` shells out to ``gcloud``
  (GCE instances with one H100 for workers, plain VMs for coordinator/aux;
  ``dry_run=True`` prints the
  exact commands without executing — the tested path in CI, and a copy-paste
  runbook for operators). Other clouds implement the same three methods.
- ``run_cloud_fleet`` is the supervisor: provision everything, then poll and
  recreate missing SPOT workers until stopped. Workers carry their
  config in the startup script, so a respawned instance rejoins the DHT and
  pulls state from peers — elasticity needs nothing cloud-side.

Every worker's startup script launches the one-command join path
(``python -m dedloc_tpu_torch.join``), so the fleet and the volunteer flows are
the same code.
"""
from __future__ import annotations

import shlex
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence

from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class CloudFleetSpec:
    """What to provision (AWS_runner.ipynb cell-2 capability)."""

    experiment_prefix: str = "dedloc"
    coordinator_machine: str = "n2-standard-8"  # r5.large-class
    num_workers: int = 16
    worker_accelerator: str = "a3-highgpu-1g"  # one H100 per peer
    num_aux: int = 4
    aux_machine: str = "n2-standard-4"
    zone: str = "us-central1-a"
    # per-worker egress shaping in Mbit/s, cycled (notebook tiers 200/100/50
    # via wondershaper); 0 = unshaped
    bandwidth_tiers: Sequence[float] = (200.0, 100.0, 100.0, 50.0)
    spot: bool = True  # preemptible workers (spot semantics)
    coordinator_port: int = 31337
    # gated runs: "user:cred,..." hosted by the coordinator's AuthService
    auth_allowlist: str = ""
    # gated runs: the fleet's OWN peers need credentials too — otherwise
    # signed volunteer leaders reject the fleet's unsigned joins and
    # matchmaking partitions into signed/unsigned subsets. A per-fleet
    # credential is auto-generated (or supplied) and appended to the
    # coordinator's allowlist; worker/aux startup scripts join with it.
    # NOTE: supply fleet_credential explicitly when re-running a supervisor
    # against an already-provisioned coordinator — a fresh auto-generated
    # value is unknown to the live coordinator's allowlist, so respawned
    # workers would be rejected.
    fleet_username: str = "fleet"
    fleet_credential: str = ""
    # software setup prefix (image/venv activation) prepended to every
    # startup script; deployments point this at their image's environment
    setup_lines: Sequence[str] = ("set -e",)
    repo_dir: str = "/srv/dedloc"  # a checkout holding dedloc_tpu_torch

    def __post_init__(self) -> None:
        if self.auth_allowlist:
            operators = {
                pair.split(":", 1)[0]
                for pair in self.auth_allowlist.split(",") if pair
            }
            if self.fleet_username in operators:
                # the coordinator lowers the allowlist into a dict, so the
                # appended fleet entry would silently override the
                # operator's user of the same name (locking those
                # volunteers out) — refuse the ambiguity at spec time
                raise ValueError(
                    f"auth_allowlist already contains user "
                    f"{self.fleet_username!r}; rename it or set "
                    f"fleet_username to something else"
                )
            if not self.fleet_credential:
                import secrets

                self.fleet_credential = secrets.token_hex(16)

    @property
    def full_allowlist(self) -> str:
        """Operator allowlist plus the fleet's own credential."""
        if not self.auth_allowlist:
            return ""
        return (
            f"{self.auth_allowlist},"
            f"{self.fleet_username}:{self.fleet_credential}"
        )


class Provider(Protocol):
    """The cloud seam: three methods cover provision/poll/replace."""

    def create(self, name: str, kind: str, machine: str,
               startup_script: str, spot: bool) -> None: ...

    def list_alive(self) -> List[str]: ...

    def delete(self, name: str, kind: str = "tpu") -> None: ...


def _shape_bandwidth_lines(mbps: float) -> List[str]:
    """tc-based egress shaping (the wondershaper capability of the
    notebook's worker user-data)."""
    if not mbps:
        return []
    rate = int(mbps)
    # tbf needs burst >= rate/HZ or it caps throughput far below the
    # nominal rate (HZ can be 100 => 200mbit needs ~250 KB); scale with rate
    burst_kbit = max(1600, rate * 10)
    return [
        "IFACE=$(ip route show default | awk '{print $5; exit}')",
        f"tc qdisc replace dev $IFACE root tbf rate {rate}mbit "
        f"burst {burst_kbit}kbit latency 400ms",
    ]


def coordinator_startup(spec: CloudFleetSpec) -> str:
    lines = list(spec.setup_lines) + [
        f"cd {spec.repo_dir}",
        " ".join([
            "python -m dedloc_tpu_torch.roles.coordinator",
            f"--dht.experiment_prefix {shlex.quote(spec.experiment_prefix)}",
            f"--dht.listen_port {spec.coordinator_port}",
            "--coordinator.upload_interval 3600",
        ] + (
            [f"--coordinator.auth_allowlist {shlex.quote(spec.full_allowlist)}"]
            if spec.auth_allowlist else []
        )),
    ]
    return "\n".join(lines)


def worker_startup(spec: CloudFleetSpec, idx: int,
                   coordinator_host: str) -> str:
    tier = (
        spec.bandwidth_tiers[idx % len(spec.bandwidth_tiers)]
        if spec.bandwidth_tiers else 0.0
    )
    lines = list(spec.setup_lines)
    lines += _shape_bandwidth_lines(tier)
    lines += [
        f"cd {spec.repo_dir}",
        " ".join([
            "python -m dedloc_tpu_torch.join",
            f"--initial_peers {coordinator_host}:{spec.coordinator_port}",
            f"--experiment_prefix {shlex.quote(spec.experiment_prefix)}",
        ] + (
            # gated fleet: join with the fleet credential (the AuthService
            # rides the coordinator's DHT port, join.py's default endpoint)
            [f"--username {shlex.quote(spec.fleet_username)}",
             f"--credential {shlex.quote(spec.fleet_credential)}"]
            if spec.auth_allowlist else []
        ) + ([f"--bandwidth {tier}", f"--training.seed {idx}"]
             if tier else [f"--training.seed {idx}"])),
    ]
    return "\n".join(lines)


def aux_startup(spec: CloudFleetSpec, coordinator_host: str) -> str:
    lines = list(spec.setup_lines) + [
        f"cd {spec.repo_dir}",
        " ".join([
            "python -m dedloc_tpu_torch.roles.aux",
            "--dht.initial_peers "
            f"{coordinator_host}:{spec.coordinator_port}",
            f"--dht.experiment_prefix {shlex.quote(spec.experiment_prefix)}",
        ] + (
            [f"--auth.username {shlex.quote(spec.fleet_username)}",
             f"--auth.credential {shlex.quote(spec.fleet_credential)}"]
            if spec.auth_allowlist else []
        )),
    ]
    return "\n".join(lines)


class _CliProvider:
    """Shared scaffolding for CLI-backed providers: command recording,
    dry-run bookkeeping, and startup-script temp files.

    ``dry_run=True`` records the exact command lines instead of executing —
    CI asserts them, operators copy-paste them (script temp files are KEPT
    in dry-run so the recorded ``file://`` references stay usable)."""

    def __init__(self, dry_run: bool = False):
        self.dry_run = dry_run
        self.commands: List[str] = []
        self.startup_scripts: Dict[str, str] = {}
        self._dry_alive: List[str] = []

    def _run(self, argv: List[str]) -> str:
        self.commands.append(" ".join(argv))
        if self.dry_run:
            return ""
        out = subprocess.run(
            argv, capture_output=True, text=True, timeout=600
        )
        if out.returncode != 0:
            raise RuntimeError(
                f"{argv[0]} failed ({out.returncode}): {out.stderr.strip()}"
            )
        return out.stdout

    def _with_script_file(self, name: str, content: str, fn) -> None:
        """Write ``content`` to a temp file, call ``fn(path)``, clean up —
        except in dry-run, where the file must outlive the recorded
        command for operators to replay it."""
        import os as _os
        import tempfile

        script_file = tempfile.NamedTemporaryFile(
            "w", prefix=f"startup-{name}-", suffix=".sh", delete=False
        )
        script_file.write(content)
        script_file.close()
        try:
            fn(script_file.name)
        finally:
            if not self.dry_run:
                _os.unlink(script_file.name)


class GceGpuProvider(_CliProvider):
    """gcloud-backed provider on Compute Engine only: every worker
    (``kind`` "tpu", the fleet's accelerated worker) is an instance with
    one H100, the coordinator and aux peers plain VMs.

    A GPU instance cannot live-migrate, so it is created with
    ``--maintenance-policy=TERMINATE``; a spot worker is deleted when it is
    reclaimed and ``run_cloud_fleet`` recreates it by name. The machine
    type (``CloudFleetSpec.worker_accelerator``, "a3-highgpu-1g": one H100
    80GB, from Google Cloud's "GPU machine types" page) and the boot image
    (a Deep Learning VM image family that carries CUDA) are defaults an
    operator overrides."""

    def __init__(self, zone: str, dry_run: bool = False,
                 image_family: str = "common-cu128-ubuntu-2204-nvidia-570",
                 image_project: str = "deeplearning-platform-release",
                 boot_disk_gb: int = 200):
        super().__init__(dry_run)
        self.zone = zone
        self.image_family = image_family
        self.image_project = image_project
        self.boot_disk_gb = boot_disk_gb

    def create(self, name: str, kind: str, machine: str,
               startup_script: str, spot: bool) -> None:
        # the script goes through --metadata-from-file: an inline
        # --metadata value would need quoting the guest shell must NOT see
        # (argv exec adds no shell layer to strip it) and commas inside the
        # script would split metadata entries
        self.startup_scripts[name] = startup_script
        self._with_script_file(
            name, startup_script,
            lambda path: self._create_with_script(name, kind, machine, path,
                                                  spot),
        )
        if self.dry_run:
            self._dry_alive.append(name)

    def _create_with_script(self, name: str, kind: str, machine: str,
                            script_path: str, spot: bool) -> None:
        argv = [
            "gcloud", "compute", "instances", "create", name,
            f"--zone={self.zone}",
            f"--machine-type={machine}",
            f"--metadata-from-file=startup-script={script_path}",
        ]
        if kind == "tpu":
            argv += [
                "--maintenance-policy=TERMINATE",
                f"--image-family={self.image_family}",
                f"--image-project={self.image_project}",
                f"--boot-disk-size={self.boot_disk_gb}GB",
            ]
        if spot:
            argv += ["--provisioning-model=SPOT",
                     "--instance-termination-action=DELETE"]
        self._run(argv)

    def list_alive(self) -> List[str]:
        if self.dry_run:
            self.commands.append("gcloud compute instances list ...")
            return list(self._dry_alive)
        out = self._run([
            "gcloud", "compute", "instances", "list",
            f"--zones={self.zone}", "--format=value(name)",
        ])
        return [n for n in out.splitlines() if n]

    def delete(self, name: str, kind: str = "tpu") -> None:
        self._run(["gcloud", "compute", "instances", "delete", name,
                   f"--zone={self.zone}", "--quiet"])


class AwsEc2Provider(_CliProvider):
    """aws-cli-backed provider — the reference's actual cloud
    (albert/AWS_runner.ipynb: r5.large coordinator + g4dn spot workers +
    CPU aux, provisioned via boto3; here via the ``aws ec2`` CLI so the
    dry-run surface matches the gcloud driver's).

    ``kind`` maps onto instance types, not services: EC2 has no TPU-VM
    analogue, so "tpu" means "accelerated worker instance" (the notebook's
    g4dn class). Spot uses the notebook's one-time,
    terminate-on-interruption semantics — the respawn loop in
    ``run_cloud_fleet`` is what brings capacity back, exactly like the
    notebook's last cell. Instances are discovered by a fleet Name tag."""

    def __init__(self, region: str, ami: str = "AMI_ID",
                 key_name: str = "", security_group: str = "",
                 dry_run: bool = False):
        super().__init__(dry_run)
        self.region = region
        self.ami = ami
        self.key_name = key_name
        self.security_group = security_group

    def create(self, name: str, kind: str, machine: str,
               startup_script: str, spot: bool) -> None:
        self.startup_scripts[name] = startup_script
        # user-data rides in a file as the RAW script: file:// contents are
        # base64-encoded by the aws CLI itself, so pre-encoding would hand
        # cloud-init base64 text instead of an executable script
        self._with_script_file(
            name, startup_script, lambda path: self._run_create(
                name, machine, path, spot
            )
        )
        if self.dry_run:
            self._dry_alive.append(name)

    def _run_create(self, name: str, machine: str, script_path: str,
                    spot: bool) -> None:
        argv = [
            "aws", "ec2", "run-instances",
            f"--region={self.region}",
            f"--image-id={self.ami}",
            f"--instance-type={machine}",
            "--count=1",
            f"--user-data=file://{script_path}",
            "--tag-specifications",
            "ResourceType=instance,Tags=[{Key=Name,Value=%s}]" % name,
        ]
        if self.key_name:
            argv.append(f"--key-name={self.key_name}")
        if self.security_group:
            argv.append(f"--security-group-ids={self.security_group}")
        if spot:
            # the notebook's one-time spot with terminate-on-interruption:
            # a preempted worker is GONE and the supervisor respawns it
            argv += [
                "--instance-market-options",
                "MarketType=spot,SpotOptions={SpotInstanceType=one-time,"
                "InstanceInterruptionBehavior=terminate}",
            ]
        self._run(argv)

    def list_alive(self) -> List[str]:
        if self.dry_run:
            self.commands.append("aws ec2 describe-instances ...")
            return list(self._dry_alive)
        out = self._run([
            "aws", "ec2", "describe-instances",
            f"--region={self.region}",
            "--filters", "Name=instance-state-name,Values=pending,running",
            "--query",
            "Reservations[].Instances[].Tags[?Key=='Name'].Value[]",
            "--output", "text",
        ])
        return [n for n in out.split() if n]

    def delete(self, name: str, kind: str = "tpu") -> None:
        if not self.dry_run:
            ids = self._run([
                "aws", "ec2", "describe-instances",
                f"--region={self.region}",
                "--filters", f"Name=tag:Name,Values={name}",
                "Name=instance-state-name,Values=pending,running",
                "--query", "Reservations[].Instances[].InstanceId",
                "--output", "text",
            ]).split()
        else:
            ids = [f"i-{name}"]
        if ids:
            self._run([
                "aws", "ec2", "terminate-instances",
                f"--region={self.region}", "--instance-ids", *ids,
            ])


def run_cloud_fleet(
    spec: CloudFleetSpec,
    provider: Provider,
    coordinator_host: str = "COORDINATOR_IP",
    poll_interval: float = 60.0,
    max_cycles: int = 0,
) -> Dict[str, int]:
    """Provision the fleet, then supervise: recreate missing SPOT workers
    (the notebook's respawn loop). Returns {"respawned": N} when bounded by
    ``max_cycles`` (tests); runs until interrupted otherwise."""
    prefix = spec.experiment_prefix
    provider.create(
        f"{prefix}-coordinator", "vm", spec.coordinator_machine,
        coordinator_startup(spec), spot=False,
    )
    worker_names = [f"{prefix}-worker-{i}" for i in range(spec.num_workers)]
    for i, name in enumerate(worker_names):
        provider.create(
            name, "tpu", spec.worker_accelerator,
            worker_startup(spec, i, coordinator_host), spot=spec.spot,
        )
    for i in range(spec.num_aux):
        provider.create(
            f"{prefix}-aux-{i}", "vm", spec.aux_machine,
            aux_startup(spec, coordinator_host), spot=False,
        )

    respawned = 0
    cycles = 0
    while True:
        cycles += 1
        if max_cycles and cycles > max_cycles:
            break
        alive = set(provider.list_alive())
        for i, name in enumerate(worker_names):
            if name not in alive:
                logger.info(f"worker {name} preempted; respawning")
                provider.create(
                    name, "tpu", spec.worker_accelerator,
                    worker_startup(spec, i, coordinator_host),
                    spot=spec.spot,
                )
                respawned += 1
        if max_cycles == 0 or cycles < max_cycles:
            time.sleep(poll_interval)
    return {"respawned": respawned}
