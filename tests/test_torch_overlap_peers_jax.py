"""The JAX package's two overlap-averaging peers, the reference of
``tests/test_torch_overlap_peers.py``: the same CLI flags, the same
check."""
from test_torch_overlap_peers import check_pair


def test_jax_overlap_peers_hold_equal_states_unless_one_stepped_alone(tmp_path):
    check_pair(tmp_path, "dedloc_tpu")
