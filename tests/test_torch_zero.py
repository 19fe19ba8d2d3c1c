"""ZeRO-1 in the port (``parallel/zero.py``), mirroring the JAX package's
tests/test_zero.py: the spec picks the largest divisible dim, a sharded
LAMB apply over 4 gloo ranks equals the replicated apply (and the JAX
package's replicated apply), the moments keep the sharded layout, and the
per-device footprint."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.optim import lamb as jax_lamb
from dedloc_tpu.parallel.train_step import TrainState as JaxTrainState
from dedloc_tpu.parallel.train_step import make_apply_step as jax_apply_step
from dedloc_tpu_torch.optim.lamb import Lamb
from dedloc_tpu_torch.parallel.mesh import MeshLayout, PartitionSpec as P
from dedloc_tpu_torch.parallel.zero import _spec_for_leaf, opt_state_bytes_per_device
from torch_mesh_ranks import run_ranks


def _params(rng):
    """The JAX test's tree in the port's names and layout: a Linear weight
    [out, in] is the JAX kernel [in, out] transposed."""
    kernel = rng.standard_normal((64, 128)).astype(np.float32)
    return {"dense.weight": np.ascontiguousarray(kernel.T),
            "dense.bias": rng.standard_normal(128).astype(np.float32),
            "emb": rng.standard_normal((80, 32)).astype(np.float32)}


def test_spec_shards_largest_divisible_dim():
    mesh = MeshLayout(("data",), (8,))
    assert _spec_for_leaf(torch.zeros(64, 128), mesh, "data") == P(None, "data")
    assert _spec_for_leaf(torch.zeros(80, 32), mesh, "data") == P("data", None)
    # indivisible and scalar leaves replicate
    assert _spec_for_leaf(torch.zeros(7, 3), mesh, "data") == P()
    assert _spec_for_leaf(torch.zeros([]), mesh, "data") == P()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    rng = np.random.default_rng(0)
    params = _params(rng)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    out = run_ranks(tmp_path_factory.mktemp("zero"), 4, "zero",
                    {"params": params, "grads": grads})
    return params, grads, out


def test_sharded_update_matches_replicated(sharded):
    params, grads, out = sharded
    for o in out:
        for k in params:
            np.testing.assert_allclose(o["sharded"][k], o["replicated"][k],
                                       atol=1e-6, rtol=1e-6)
    # and the JAX package's replicated apply
    tree = lambda d: {"dense": {"kernel": jnp.asarray(d["dense.weight"].T),
                                "bias": jnp.asarray(d["dense.bias"])},
                      "emb": jnp.asarray(d["emb"])}
    tx = jax_lamb(learning_rate=1e-2, weight_decay=0.01)
    new = jax_apply_step(tx)(JaxTrainState.create(tree(params), tx), tree(grads))
    np.testing.assert_allclose(out[0]["sharded"]["dense.weight"],
                               np.asarray(new.params["dense"]["kernel"]).T,
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(out[0]["sharded"]["emb"],
                               np.asarray(new.params["emb"]), atol=1e-6, rtol=1e-6)


def test_the_new_moments_keep_the_sharded_layout(sharded):
    _params_, _grads, out = sharded
    for o in out:
        # JAX kernel [64, 128] splits its 128 -> the port's [128, 64] rows
        assert o["specs"]["dense.weight"] == (None, "data")
        assert o["moment_shapes"]["dense.weight"] == (32, 64)
        assert o["moment_shapes"]["emb"] == (20, 32)
        assert o["moment_shapes"]["dense.bias"] == (32,)


def test_opt_state_bytes_per_device():
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(v) for k, v in _params(rng).items()}
    mesh = MeshLayout(("data",), (8,))
    opt_state = Lamb(learning_rate=1e-2).init(params)
    full = sum(t.numel() * 4 for f in ("mu", "nu")
               for t in getattr(opt_state, f).values()) + 2 * 4
    per_dev = opt_state_bytes_per_device(opt_state, mesh)
    # moments dominate and divide by 8; counts replicate
    assert per_dev < full / 4
