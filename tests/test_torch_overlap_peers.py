"""Overlap averaging between two real peers of each package
(``tests/torch_mesh_overlap_peers.py``): both trainer CLIs, the tiny model
on the CPU, target 48 (two boundaries of 24 samples), every step
checkpointed. In both packages the two peers' states hash equal at every
common step that neither reached through a step taken alone; a state that
differs follows a step one peer took alone at a small target, which the
JAX package does as the port does (ROADMAP §C2). The JAX package's pair
runs in ``tests/test_torch_overlap_peers_jax.py``."""
import torch_mesh_overlap_peers as op


def check_pair(tmp_path, package):
    run = op.run_pair(package, str(tmp_path), target=48, steps=4, timeout=90)
    out = op.compare(run)
    assert any(g == 2 for p in ("A", "B") for g in out["groups"][p].values()), out
    assert out["checked"], f"no common step without a solo step before it: {out}"
    assert out["checked_equal"], out
    assert out["every_difference_follows_a_solo_step"], out


def test_port_overlap_peers_hold_equal_states_unless_one_stepped_alone(tmp_path):
    check_pair(tmp_path, "dedloc_tpu_torch")
