"""The traffic generators repeat by seed, differ across seeds and are the
port's own streams."""
import numpy as np
import pytest

from portbench.traffic.mlm import synthetic_mlm_batches
from portbench.traffic.multicrop import synthetic_multicrop_batches


def _take(gen, n):
    return [next(gen) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 40])
def test_mlm_repeats_by_seed(seed):
    a = _take(synthetic_mlm_batches(30000, 3, 64, seed), 2)
    b = _take(synthetic_mlm_batches(30000, 3, 64, seed), 2)
    c = _take(synthetic_mlm_batches(30000, 3, 64, seed + 1), 1)
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not np.array_equal(a[0]["input_ids"], c[0]["input_ids"])
    assert a[0]["mlm_positions"].shape == (3, int(0.15 * 64) + 4)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_multicrop_repeats_by_seed(seed):
    a = _take(synthetic_multicrop_batches((32, 16), (2, 3), 4, seed), 2)
    b = _take(synthetic_multicrop_batches((32, 16), (2, 3), 4, seed), 2)
    c = _take(synthetic_multicrop_batches((32, 16), (2, 3), 4, seed + 1), 1)
    assert all(np.array_equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not np.array_equal(a[0][0], c[0][0])
    assert [g.shape for g in a[0]] == [(8, 32, 32, 3), (12, 16, 16, 3)]


def test_frozen_copies_match_the_port():
    from dedloc_tpu_torch.data.multicrop import MultiCropSpec
    from dedloc_tpu_torch.data.multicrop import synthetic_multicrop_batches as port_crops
    from dedloc_tpu_torch.models.albert import AlbertConfig
    from dedloc_tpu_torch.roles.common import synthetic_mlm_batches as port_mlm

    ours = _take(synthetic_mlm_batches(30000, 4, 128, 11), 2)
    theirs = _take(port_mlm(AlbertConfig.large(), 4, 128, 11), 2)
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(ours, theirs) for k in y)
    ours = next(synthetic_multicrop_batches((32, 16), (2, 2), 3, 5))
    theirs = next(port_crops(MultiCropSpec.tiny(), 3, seed=5))
    assert all(np.array_equal(x, y) for x, y in zip(ours, theirs))
