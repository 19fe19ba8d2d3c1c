"""The port's ring attention (``parallel/ring_attention.py``) over gloo
ranks of a seq axis, mirroring the JAX package's
tests/test_ring_attention.py: outputs with and without a key mask and the
gradients of q, k and v equal to dense attention (and the JAX ring on a
mesh of the same shape); and the ALBERT slice with its sequence split over
2 ranks of a dp2 x sp2 mesh (``attention_impl="ring"``) against the JAX
trainer's slice over 2 LAMB steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from dedloc_tpu.parallel.ring_attention import dense_attention, ring_attention
from torch_mesh_jax import (
    assert_matches_jax,
    assert_replicas_bitwise,
    batches,
    jax_steps,
    port_inputs,
    weights,
)
from torch_mesh_ranks import run_ranks

S = 64


def _qkv(rng, b=2, s=S, h=2, d=8):
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng)
    q2, k2, v2 = _qkv(rng)
    mask = rng.random((2, S)) > 0.3
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    inputs = dict(q=q, k=k, v=v, q2=q2, k2=k2, v2=v2, bias=bias)
    out = run_ranks(tmp_path_factory.mktemp("ring"), 4, "ring", inputs)
    return inputs, out


def _joined(out, key):
    return np.concatenate([o[key] for o in out], axis=1)


def test_ring_matches_dense(case):
    inputs, out = case
    q, k, v = (jnp.asarray(inputs[n]) for n in "qkv")
    ref = np.asarray(dense_attention(q, k, v))
    np.testing.assert_allclose(_joined(out, "plain"), ref, atol=1e-5)
    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    jax_ring = np.asarray(jax.jit(lambda a, b, c: ring_attention(a, b, c, mesh=mesh))(q, k, v))
    np.testing.assert_allclose(_joined(out, "plain"), jax_ring, atol=1e-5)


def test_ring_with_mask_matches_dense(case):
    inputs, out = case
    q, k, v = (jnp.asarray(inputs[n]) for n in "qkv")
    ref = np.asarray(dense_attention(q, k, v, jnp.asarray(inputs["bias"])))
    np.testing.assert_allclose(_joined(out, "masked"), ref, atol=1e-5)


def test_ring_gradients_flow(case):
    inputs, out = case
    q, k, v = (jnp.asarray(inputs[n + "2"]) for n in "qkv")
    g_dense = jax.grad(lambda *a: jnp.sum(dense_attention(*a) ** 2),
                       argnums=(0, 1, 2))(q, k, v)
    for i, gd in enumerate(g_dense):
        got = np.concatenate([o["grads"][i] for o in out], axis=1)
        np.testing.assert_allclose(got, np.asarray(gd), atol=1e-4)


def test_albert_ring_impl_matches_jax_slice(tmp_path):
    """dp2 x sp2: each rank holds 4 rows x 16 positions; position ids and
    the key bias start at its shard, the masked positions it holds count
    on the slice's totals, the SOP sample on the first seq rank."""
    w, b = weights(), batches()
    axes, shape = ("data", "seq"), (2, 2)
    ref = jax_steps(axes, shape, w, b)
    outs = run_ranks(tmp_path, 4, "albert_steps", port_inputs(axes, shape, w, b))
    assert_matches_jax(outs[0], ref)
    assert_replicas_bitwise(outs, axes, shape)
