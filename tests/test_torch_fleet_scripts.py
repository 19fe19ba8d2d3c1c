"""The port's fleet scripts (``dedloc_tpu_torch/tools/*.sh``, the
counterparts of ``tools/hetero_converge.sh``, ``hetero_run.sh``,
``swav_hetero.sh`` and ``run_monitor.sh``): each is valid bash, and every
role it starts — run with ``python`` and ``sleep`` stubbed on the PATH, so
nothing starts — is the port's, with flags its own ``parse_config``
parses; the card trainer runs without ``DEDLOC_FORCE_CPU`` and the CPU
volunteers with it."""
import os
import stat
import subprocess
import time
from pathlib import Path

import pytest

from dedloc_tpu_torch.core.config import (
    CollaborationArguments,
    SwAVCollaborationArguments,
    parse_config,
)
from dedloc_tpu_torch.roles.coordinator import CoordinatorCLIArguments

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "dedloc_tpu_torch" / "tools"
SCRIPTS = ("hetero_converge.sh", "hetero_run.sh", "swav_hetero.sh",
           "run_monitor.sh", "sustained_runs.sh")
PARSERS = {"trainer": CollaborationArguments, "aux": CollaborationArguments,
           "coordinator": CoordinatorCLIArguments,
           "swav": SwAVCollaborationArguments}
# the stub records each call: its arguments, then whether the CPU was asked for
# (one write per call: roles started together append at once)
STUB = """#!/bin/bash
rec=""
for a in "$@"; do rec+="$a"$'\\x1f'; done
printf '%sFORCE_CPU=%s\\x1e' "$rec" "${DEDLOC_FORCE_CPU:-}" >> "$STUB_LOG"
"""


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_is_valid_bash(script):
    subprocess.run(["bash", "-n", str(TOOLS / script)], check=True, timeout=30)


def _run(tmp_path, script, args=(), **env):
    stub_dir = tmp_path / "stub"
    stub_dir.mkdir(exist_ok=True)
    # a short sleep: the roles started just before write their record
    # before the script's next kill reaches them
    for name, body in (("python", STUB), ("sleep", "#!/bin/sh\nexec /bin/sleep 0.3\n")):
        path = stub_dir / name
        path.write_text(body)
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / f"{script}.calls"
    e = {k: v for k, v in os.environ.items() if k != "DEDLOC_FORCE_CPU"}
    e.update(PATH=f"{stub_dir}:{os.environ['PATH']}", STUB_LOG=str(log),
             CORPUS=str(tmp_path / "corpus"), RUN=str(tmp_path / "run"), **env)
    subprocess.run(["bash", str(TOOLS / script), *args], env=e, check=True,
                   timeout=60, capture_output=True)
    # roles started in the background may still be writing their record
    size, deadline = -1, time.monotonic() + 10
    while time.monotonic() < deadline:
        now = log.stat().st_size if log.exists() else 0
        if now == size:
            break
        size = now
        time.sleep(0.5)
    calls = []
    for record in log.read_text().split("\x1e"):
        if record:
            *argv, force = record.split("\x1f")
            calls.append((argv, force == "FORCE_CPU=1"))
    return calls


def _roles(calls):
    out = []
    for argv, force_cpu in calls:
        if argv[:1] == ["-m"] and argv[1].startswith("dedloc_tpu_torch.roles."):
            role = argv[1].rsplit(".", 1)[1]
            args = parse_config(PARSERS[role], argv[2:])
            out.append((role, args, force_cpu))
    return out


@pytest.mark.parametrize("mode", ["probe", "converge", "solo"])
def test_hetero_converge_starts_the_port_roles(tmp_path, mode):
    roles = _roles(_run(tmp_path, "hetero_converge.sh", MODE=mode, TOTAL="30000"))
    names = sorted(r for r, _, _ in roles)
    if mode == "solo":
        assert names == ["trainer"]
    else:
        trainers = 1 + (2 if mode == "probe" else 4)  # churn restarts two
        assert names == ["aux", "coordinator"] + ["trainer"] * trainers
    card = [a for r, a, cpu in roles if r == "trainer" and not cpu]
    vols = [a for r, a, cpu in roles if r == "trainer" and cpu]
    assert len(card) == 1
    assert card[0].training.attention_impl == "flash"
    assert card[0].training.remat_policy == "fused_ln"
    assert card[0].optimizer.target_batch_size == 512
    assert card[0].training.learning_rate == pytest.approx(6e-4)
    assert card[0].training.warmup_steps == 250
    for v in vols:
        assert v.dht.client_mode and v.training.per_device_batch_size == 1
        assert v.training.attention_impl == "dense"


def test_hetero_run_and_swav_hetero_start_the_port_roles(tmp_path):
    roles = _roles(_run(tmp_path, "hetero_run.sh"))
    assert sorted(r for r, _, _ in roles) == ["aux", "coordinator"] + ["trainer"] * 4
    assert sum(not cpu for r, _, cpu in roles if r == "trainer") == 1
    roles = _roles(_run(tmp_path, "swav_hetero.sh"))
    assert sorted(r for r, _, _ in roles) == ["aux", "coordinator", "swav", "swav", "swav"]
    card = [a for r, a, cpu in roles if r == "swav" and not cpu]
    assert len(card) == 1 and card[0].training.queue_length == 3840


def test_run_monitor_reads_the_run_through_the_port(tmp_path):
    calls = _run(tmp_path, "run_monitor.sh", args=[str(tmp_path / "run")])
    assert calls[0][0] == ["-m", "dedloc_tpu_torch.tools.sustained", "monitor",
                           str(tmp_path / "run")]
