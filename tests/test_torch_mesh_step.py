"""The port's slice steps against the JAX trainer's on a mesh of the same
shape, from the same weights and micro-batches, over 2 LAMB steps:
data-parallel (dp2), dp2 x tp2 with ZeRO-1 for the leaves TP leaves
replicated, and ZeRO-1 alone. Losses (the slice's global means; the dp2
case's first micro-batch holds very different masked-token counts on its
two data shards, which only a global mean passes), mean gradients, the
params after the steps, and replicated leaves and moments bitwise equal
across the ranks that hold them."""
import numpy as np
import pytest

from torch_mesh_jax import (
    assert_matches_jax,
    assert_replicas_bitwise,
    batches,
    jax_steps,
    port_inputs,
    weights,
)
from torch_mesh_ranks import run_ranks

CASES = {
    "dp2": dict(axes=("data",), shape=(2,), zero=False, uneven=True),
    "dp2_tp2_zero": dict(axes=("data", "model"), shape=(2, 2), zero=True,
                         uneven=False),
    "zero_dp2": dict(axes=("data",), shape=(2,), zero=True, uneven=False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    w, cache = weights(), {}

    def get(name):
        if name not in cache:
            c = CASES[name]
            b = batches(uneven=c["uneven"])
            ref = jax_steps(c["axes"], c["shape"], w, b, zero=c["zero"])
            outs = run_ranks(tmp_path_factory.mktemp(name), int(np.prod(c["shape"])),
                             "albert_steps",
                             port_inputs(c["axes"], c["shape"], w, b, zero=c["zero"]))
            cache[name] = (ref, outs)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_slice_steps_match_jax(runs, name):
    ref, outs = runs(name)
    assert_matches_jax(outs[0], ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_replicated_leaves_and_moments_bitwise_across_ranks(runs, name):
    _ref, outs = runs(name)
    c = CASES[name]
    assert_replicas_bitwise(outs, c["axes"], c["shape"])
    # every rank reports the slice's loss, the same value
    assert len({o["metrics"][0][0]["loss"] for o in outs}) == 1


def test_uneven_counts_need_the_global_mean(runs):
    """The dp2 case's first micro-batch: the mean of the two shards' means
    is far from the slice's mean, which both packages report."""
    ref, outs = runs("dp2")
    b = batches(uneven=True)[0][0]
    w = b["mlm_weights"]
    half = len(w) // 2
    assert w[:half].sum() > 4 * w[half:].sum()
    np.testing.assert_allclose(outs[0]["metrics"][0][0]["mlm_loss"],
                               ref["metrics"][0][0]["mlm_loss"], rtol=1e-5)


def test_zero_shards_the_moments_and_tp_keeps_its_layout(runs):
    _ref, outs = runs("dp2_tp2_zero")
    ospecs = outs[0]["ospecs"]
    assert any("model" in s for s in ospecs.values())
    assert any("data" in s for s in ospecs.values())
    q = "albert.encoder.layer.block.attention.query.weight"
    assert outs[0]["pspecs"][q] == (None, "model")
    # the port's [out, in] weight holds 16 of the 32 output rows
    assert outs[0]["shapes"][q] == (16, 32)
    assert outs[0]["shapes"]["mu:albert.pooler.weight"] == (32, 16)
