"""What a run imports, compared by whole top-level names (the part before
the first dot): no JAX, no JAX package; the plain reference imports
nothing of the port. Each check runs in a fresh interpreter."""
import json
import subprocess
import sys

import pytest

from portbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dedloc_tpu"}

RUN = """
import json, sys, time
sys.path.insert(0, {repo!r})
from pathlib import Path
from portbench import harness
from portbench.tests import tiny
root = tiny.tiny_root(Path({tmp!r}))
harness.run({cell!r}, 5, 0.2, False, time.perf_counter(), device="cpu", root=root)
for name in {cells!r}:  # every real cell's driver, loaded as a run loads it
    ctx = harness.resolve(name, Path({repo!r}))
    harness.load_module(ctx.driver_path, "driver_" + name.replace(".", "_"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys, types
sys.path.insert(0, {repo!r})
import torch
from portbench.reference import albert, compare, init, optim, swav, train
from portbench.tests import tiny
c = json.load(open({repo!r} + "/portbench/configs/albert-large.json"))
c.update(tiny.TINY_ALBERT)
w = init.draw(albert.spec(c), 1, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", ["tiny-albert.cpu", "tiny-swav.cpu"])
def test_a_run_loads_no_jax(tmp_path, cell):
    cells = [w["name"] for w in json.loads((tiny.REPO / "BENCHMARK.json").read_text())[
        "workloads"]]
    mods = _modules(RUN.format(repo=str(tiny.REPO), tmp=str(tmp_path), cell=cell,
                               cells=cells))
    assert not mods & FORBIDDEN
    assert "dedloc_tpu_torch" in mods


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules(REFERENCE.format(repo=str(tiny.REPO)))
    assert "dedloc_tpu_torch" not in mods and not mods & FORBIDDEN
