"""``graft_entry``'s collaborative dryrun on the CPU: two slice peers of 2
gloo ranks each — one tensor-parallel, one pipeline-parallel — through
the trainer role, averaging over a real DHT. The JAX package's
``__graft_entry__.py`` asserts that a real 2-slice group forms (its slices
have 4 virtual devices each; the port's tests spawn at most 4 ranks)."""
from dedloc_tpu_torch import graft_entry


def test_two_collaborative_slices_form_a_group():
    groups = graft_entry._dryrun_collaborative_slices("cpu")
    assert sorted(groups) == ["slice0", "slice1"]
    for name, sizes in groups.items():
        assert 2 in sizes, f"{name} never averaged with the other slice: {sizes}"
