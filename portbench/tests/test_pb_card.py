"""On the card: a cell's run, and the control at the cell's own size.

    python -m pytest portbench/tests -m card

The control is the plain reference put in the program's place in
bfloat16 throughout; it has to fail the cell's limits where the program
passes them, and so have the reference with half of each step's samples
left out and the reference with its updates of the wrong sign."""
import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

CELLS = ["albert-large.s512", "swav-resnet50.b128", "albert-large.s16k"]


@pytest.mark.card
def test_a_run_prints_a_correct_result(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
         str(2 ** 31 + 11), "--seconds", "3", "--trace", "1"],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert out.stderr.strip().splitlines()[-1].startswith("compared ")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_where_the_program_passes(card, cell):
    import torch

    from portbench.reference import compare

    ctx = harness.resolve(cell, tiny.REPO)
    ctx.device = "cuda"
    driver = harness.load_module(ctx.driver_path, "pb_card_driver")
    limits = ctx.cell["limits"]
    for seed in (2 ** 31 + 21, 22, 23)[: 3 if cell == CELLS[0] else 1]:
        ctx.seed = seed
        program, readings = harness.first_steps(ctx, driver)
        program.close()
        numbers, ref, _s = harness.against_reference(ctx, driver, readings)
        assert compare.judge(numbers, limits), numbers
        for broken in (dict(dtype=torch.bfloat16), dict(half=True), dict(flip=True)):
            got = driver.reference(ctx, ctx.cell["reference_steps"], **broken)
            assert not compare.judge(compare.gaps(got, ref), limits), broken
