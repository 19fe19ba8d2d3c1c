"""Overlap averaging on a slice: a data-parallel slice of 2 gloo ranks
(tiny fp32 ALBERT, LAMB) against a one-device port peer on the same
micro-batches, both averaging through ``tests/test_torch_overlap.py``'s
stub averager. A landed round applies one boundary late on every rank and
keeps the ranks' in-flight accumulation; a failed round restores each
rank's own committed parts (never the gathered full sums) before the
synchronous fallback."""
import numpy as np
import pytest

from torch_mesh_cases import overlap_peer
from torch_mesh_jax import LAMB, weights
from torch_mesh_ranks import run_ranks

# the late apply from the slice's contribution against the one-device
# peer's (fp32, the slice's sums in another order): params within 1e-6
# relative; the restored accumulators within 1e-5 relative (of the whole
# tree, ``_close``)
PARAM_RTOL = 1e-6
ACC_RTOL = 1e-5
BATCH, SEQ = 8, 32


def _inputs(scenario):
    import torch

    from dedloc_tpu_torch.models.albert import AlbertConfig
    from dedloc_tpu_torch.roles.common import loss_keys, synthetic_mlm_batches

    it = synthetic_mlm_batches(AlbertConfig.tiny(), BATCH, SEQ, seed=4)
    batches = []
    for _ in range(3):
        host = next(it)
        batches.append({k: host[k] for k in loss_keys(host)})
    return dict(scenario=scenario, batches=batches, weights=weights(),
                cfg=dict(dtype=torch.float32), lamb=LAMB)


@pytest.fixture(scope="module", params=["success", "failure"])
def runs(request, tmp_path_factory):
    inputs = _inputs(request.param)
    ranks = run_ranks(tmp_path_factory.mktemp(request.param), 2, "overlap_slice", inputs)
    return request.param, overlap_peer(inputs), ranks


def _close(got, want, rtol):
    """Relative error of the whole tree (the norm over every leaf): a leaf
    whose gradient is 0 analytically (the attention's key bias) holds only
    rounding noise in both, and LAMB scales that noise up to a step."""
    assert sorted(got) == sorted(want)
    keys = sorted(want)
    flat = lambda tree: np.concatenate([np.ravel(tree[k]).astype(np.float64) for k in keys])
    g, w = flat(got), flat(want)
    assert np.linalg.norm(g - w) <= rtol * np.linalg.norm(w), \
        np.linalg.norm(g - w) / np.linalg.norm(w)


def test_late_apply_and_restore_match_the_one_device_peer(runs):
    scenario, single, ranks = runs
    lead = ranks[0]
    assert lead["stepped"] == single["stepped"]
    assert lead["calls"] == single["calls"]
    for o in ranks:
        assert o["stepped"] == lead["stepped"] and o["n_acc"] == single["n_acc"]
        # each rank's params are the slice's: bitwise equal across ranks
        assert all(np.array_equal(o["params"][k], lead["params"][k]) for k in o["params"])
        assert o["committed"] is False  # the flight resolved on every rank
    if scenario == "success":
        assert lead["stepped"] == [False, False, True]
        assert lead["calls"] == [True]
        _close(lead["params"], single["params"], PARAM_RTOL)
        # the micro-batches of boundaries 2 and 3 stay for the next round
        assert single["n_acc"] == 2
        _close(lead["acc"], single["acc"], ACC_RTOL)
    else:
        assert lead["stepped"] == [False, False]
        assert lead["calls"] == [True, False]  # the synchronous fallback
        assert lead["cooldown"] and single["cooldown"]
        # restored: boundary 1's committed parts plus boundary 2's, summed
        # over the ranks as the one device holds them
        assert single["n_acc"] == 2
        _close(lead["acc"], single["acc"], ACC_RTOL)
        want = weights()
        for k, v in lead["params"].items():  # no update was applied
            np.testing.assert_array_equal(v, want[k], err_msg=k)
