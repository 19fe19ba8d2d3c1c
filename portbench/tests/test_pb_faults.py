"""A run with the timed path broken underneath reads ``correct`` false:
once for each fault a one-chip training cell can have. The harness's look
for a card is skipped (the CPU runs the program's plain path at a tiny
size); the rest of a run is driven as the command drives it.

- a step that returns its state unchanged (the apply patched out);
- half of the batch left out, the mean taken over the rest (the move to
  the device patched to keep half of the rows);
- an update of the wrong sign (the apply patched to reflect each
  parameter's change), which keeps every leaf's change norm.

A one-chip cell has no exchange between chips, and a training step
produces no token or answer of its own to alter: the loss it reports is
compared, not produced for a user."""
import time

import pytest
import torch

import dedloc_tpu_torch.models.swav as port_swav
import dedloc_tpu_torch.parallel.train_step as port_step
import dedloc_tpu_torch.roles.common as port_common
from portbench import harness
from portbench.tests import tiny


def _unchanged(real):
    def make(*args, **kwargs):
        real(*args, **kwargs)
        return lambda state, grads: (state, torch.ones((), dtype=torch.bool))
    return make


def _half_rows(real):
    def move(batch, *args, **kwargs):
        out = real(batch, *args, **kwargs)
        if isinstance(out, dict):
            return {k: v[: v.shape[0] // 2] for k, v in out.items()}
        return [t.reshape(-1, 4, *t.shape[1:])[:, :2].reshape(-1, *t.shape[1:])
                for t in out]
    return move


def _flipped(real):
    def make(*args, **kwargs):
        apply = real(*args, **kwargs)

        def step(state, grads):
            before = {n: p.detach().clone() for n, p in state.params.items()}
            state, ok = apply(state, grads)
            with torch.no_grad():
                for n, p in state.params.items():
                    p.copy_(2 * before[n] - p)
            return state, ok
        return step
    return make


FAULTS = {
    "state_unchanged": (port_step, "make_flat_apply_step", _unchanged),
    "update_flipped": (port_step, "make_flat_apply_step", _flipped),
    "half_batch_albert": (port_common, "drop_collator_keys", _half_rows),
    "half_batch_swav": (port_swav, "crop_tensors", _half_rows),
}


def _run(root, cell):
    return harness.run(cell, 12345, 0.3, False, time.perf_counter(), device="cpu",
                       root=root)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {"tiny-albert.cpu": tiny.tiny_root(tmp_path_factory.mktemp("a")),
            "tiny-swav32.cpu": tiny.tiny_swav_fp32_root(tmp_path_factory.mktemp("s"))}


@pytest.mark.parametrize("cell", ["tiny-albert.cpu", "tiny-swav32.cpu"])
def test_sound_run_is_correct(roots, cell):
    assert _run(roots[cell], cell)["correct"] is True


@pytest.mark.parametrize("cell,fault", [
    ("tiny-albert.cpu", "state_unchanged"), ("tiny-albert.cpu", "half_batch_albert"),
    ("tiny-albert.cpu", "update_flipped"),
    ("tiny-swav32.cpu", "state_unchanged"), ("tiny-swav32.cpu", "half_batch_swav"),
    ("tiny-swav32.cpu", "update_flipped")])
def test_fault_reads_incorrect(roots, cell, fault, monkeypatch):
    module, name, wrap = FAULTS[fault]
    monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    result = _run(roots[cell], cell)
    assert result["correct"] is False, result["compared"]
