"""The port's cloud fleet (``dedloc_tpu_torch/roles/cloud.py``), through
fake and dry-run providers only, as ``tests/test_cloud.py`` tests the JAX
package's: every role is provisioned and preempted workers respawn, the
startup scripts shape bandwidth and launch the port's join path, gated
fleets carry their credentials, and the GCE provider creates its workers as
one-H100 GPU instances (terminate on host maintenance, spot where asked).
No card, no network and no cloud CLI are needed."""
from dedloc_tpu_torch.roles.cloud import (
    AwsEc2Provider,
    CloudFleetSpec,
    GceGpuProvider,
    aux_startup,
    coordinator_startup,
    run_cloud_fleet,
    worker_startup,
)


class FakeProvider:
    def __init__(self):
        self.created = []  # (name, kind, machine, startup, spot)
        self.alive = set()

    def create(self, name, kind, machine, startup_script, spot):
        self.created.append((name, kind, machine, startup_script, spot))
        self.alive.add(name)

    def list_alive(self):
        return list(self.alive)

    def delete(self, name, kind="tpu"):
        self.alive.discard(name)


def test_fleet_provisions_all_roles_and_respawns_preempted_workers():
    spec = CloudFleetSpec(experiment_prefix="run1", num_workers=3, num_aux=2,
                          bandwidth_tiers=(200.0, 50.0))
    provider = FakeProvider()
    run_cloud_fleet(spec, provider, "10.0.0.9", poll_interval=0.0, max_cycles=1)
    assert len(provider.created) == 1 + 3 + 2
    kinds = {(n.rsplit("-", 1)[0], k) for n, k, *_ in provider.created}
    assert ("run1-worker", "tpu") in kinds and ("run1-aux", "vm") in kinds
    # the port's workers are one-H100 machines
    assert {m for n, _k, m, *_ in provider.created if "worker" in n} == {"a3-highgpu-1g"}

    provider.alive.discard("run1-worker-0")
    provider.alive.discard("run1-worker-2")
    run_cloud_fleet(spec, provider, "10.0.0.9", poll_interval=0.0, max_cycles=1)
    respawned = {c[0] for c in provider.created[6:] if c[0].startswith("run1-worker")}
    assert {"run1-worker-0", "run1-worker-2"} <= respawned


def test_worker_startup_script_shapes_bandwidth_and_joins_the_port():
    spec = CloudFleetSpec(experiment_prefix="run2", bandwidth_tiers=(200.0, 100.0))
    s0 = worker_startup(spec, 0, "10.1.1.1")
    s1 = worker_startup(spec, 1, "10.1.1.1")
    assert "tc qdisc replace" in s0 and "rate 200mbit" in s0
    assert "rate 100mbit" in s1
    assert "python -m dedloc_tpu_torch.join" in s0
    assert "python -m dedloc_tpu.join" not in s0
    assert "--initial_peers 10.1.1.1:31337" in s0
    assert "--experiment_prefix run2" in s0
    assert f"cd {spec.repo_dir}" in s0
    assert "rate 200mbit" in worker_startup(spec, 2, "10.1.1.1")


def test_coordinator_startup_hosts_auth_when_gated():
    spec = CloudFleetSpec(auth_allowlist="alice:pw,bob:pw2")
    s = coordinator_startup(spec)
    assert "python -m dedloc_tpu_torch.roles.coordinator" in s
    assert "--coordinator.auth_allowlist" in s and "alice:pw,bob:pw2" in s
    assert "auth_allowlist" not in coordinator_startup(CloudFleetSpec())
    assert "python -m dedloc_tpu_torch.roles.aux" in aux_startup(spec, "h")


def test_gce_dry_run_creates_one_h100_gpu_workers():
    spec = CloudFleetSpec(num_workers=2, num_aux=1)
    provider = GceGpuProvider(zone=spec.zone, dry_run=True)
    run_cloud_fleet(spec, provider, "10.0.0.1", poll_interval=0.0, max_cycles=1)
    assert not any("tpu-vm" in c for c in provider.commands)
    creates = [c for c in provider.commands
               if c.startswith("gcloud compute instances create")]
    assert len(creates) == 1 + 2 + 1  # coordinator, workers, aux
    workers = [c for c in creates if "worker" in c.split()[4]]
    assert len(workers) == 2
    for cmd in workers:
        argv = cmd.split()
        assert f"--zone={spec.zone}" in argv
        assert "--machine-type=a3-highgpu-1g" in argv
        assert "--maintenance-policy=TERMINATE" in argv
        assert "--provisioning-model=SPOT" in argv
        assert "--instance-termination-action=DELETE" in argv
        assert any(a.startswith("--image-family=") for a in argv)
        assert any(a.startswith("--metadata-from-file=startup-script=") for a in argv)
    for cmd in creates:
        if cmd not in workers:  # coordinator and aux: plain on-demand VMs
            assert "SPOT" not in cmd and "--maintenance-policy" not in cmd
    scripts = [v for k, v in provider.startup_scripts.items() if "worker" in k]
    assert scripts and all(s.startswith("set -e") for s in scripts)
    assert all("python -m dedloc_tpu_torch.join" in s for s in scripts)
    # on-demand workers stay on-demand, still terminated on maintenance
    on_demand = GceGpuProvider(zone="z", dry_run=True)
    on_demand.create("w", "tpu", "a3-highgpu-1g", "set -e", spot=False)
    assert "--maintenance-policy=TERMINATE" in on_demand.commands[-1]
    assert "SPOT" not in on_demand.commands[-1]
    on_demand.delete("w")
    assert on_demand.commands[-1] == "gcloud compute instances delete w --zone=z --quiet"


def test_gated_fleet_wires_credentials_into_all_roles():
    spec = CloudFleetSpec(auth_allowlist="alice:pw")
    assert spec.fleet_credential
    coord = coordinator_startup(spec)
    assert f"fleet:{spec.fleet_credential}" in coord and "alice:pw" in coord
    worker = worker_startup(spec, 0, "10.0.0.1")
    assert "--username fleet" in worker
    assert f"--credential {spec.fleet_credential}" in worker
    aux = aux_startup(spec, "10.0.0.1")
    assert "--auth.username fleet" in aux
    assert f"--auth.credential {spec.fleet_credential}" in aux
    open_spec = CloudFleetSpec()
    assert not open_spec.fleet_credential
    assert "--username" not in worker_startup(open_spec, 0, "h")
    assert "--auth.username" not in aux_startup(open_spec, "h")


def test_aws_dry_run_emits_well_formed_commands():
    spec = CloudFleetSpec(num_workers=2, num_aux=1,
                          worker_accelerator="p5.4xlarge",
                          coordinator_machine="r5.large")
    provider = AwsEc2Provider(region="us-east-1", ami="ami-123", dry_run=True)
    run_cloud_fleet(spec, provider, "10.0.0.1", poll_interval=0.0, max_cycles=1)
    runs = [c for c in provider.commands if c.startswith("aws ec2 run-instances")]
    assert len(runs) == 4
    worker_runs = [c for c in runs if "--instance-type=p5.4xlarge" in c]
    assert len(worker_runs) == 2
    for cmd in worker_runs:
        assert "MarketType=spot" in cmd
        assert "InstanceInterruptionBehavior=terminate" in cmd
        assert "--user-data=file://" in cmd
    coord_runs = [c for c in runs if "--instance-type=r5.large" in c]
    assert len(coord_runs) == 1 and "MarketType=spot" not in coord_runs[0]
    assert "python -m dedloc_tpu_torch.join" in provider.startup_scripts[
        "dedloc-worker-0"]
    provider.delete("dedloc-worker-0", kind="tpu")
    assert provider.commands[-1].startswith("aws ec2 terminate-instances")
