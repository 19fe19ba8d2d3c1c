"""The port's GPipe schedule (``parallel/pipeline.py``) on gloo ranks,
mirroring the JAX package's tests/test_pipeline.py: outputs and gradients
equal to the sequential stack (and to the JAX pipeline on a mesh of the
same shape), a rank's ``[1, ...]`` block of stacked stage params, the
composition with a data axis, the refusals of a wrong stage count and of
the pipe axis in ``micro_spec``; and the ALBERT slice with its shared
block staged over 2 ranks of a dp2 x pp2 mesh against the JAX trainer's
slice over 2 LAMB steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from dedloc_tpu.parallel.mesh import make_mesh
from dedloc_tpu.parallel.pipeline import pipeline_apply
from torch_mesh_jax import (
    assert_matches_jax,
    assert_replicas_bitwise,
    batches,
    jax_steps,
    port_inputs,
    weights,
)
from torch_mesh_ranks import run_ranks

STAGES, WIDTH = 4, 16


def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _sequential(params, micro, stages=STAGES):
    def run_one(x):
        for s in range(stages):
            x = _stage_fn(jax.tree_util.tree_map(lambda p: p[s], params), x)
        return x

    return jax.vmap(run_one)(micro)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = {
        "params": {"w": rng.normal(0, 0.5, (STAGES, WIDTH, WIDTH)).astype(np.float32),
                   "b": rng.normal(0, 0.1, (STAGES, WIDTH)).astype(np.float32)},
        "micro": rng.normal(0, 1, (6, 8, WIDTH)).astype(np.float32),
        "micro2": rng.normal(0, 1, (5, 4, WIDTH)).astype(np.float32),
        "tgt": rng.normal(0, 1, (5, 4, WIDTH)).astype(np.float32),
        "micro3": rng.normal(0, 1, (4, 2, WIDTH)).astype(np.float32),
        "micro_dp": rng.normal(0, 1, (3, 4, WIDTH)).astype(np.float32),
    }
    out = run_ranks(tmp_path_factory.mktemp("pipe"), 4, "pipeline", inputs)
    params = {k: jnp.asarray(v) for k, v in inputs["params"].items()}
    return inputs, params, out


def test_pipeline_matches_sequential(case):
    inputs, params, out = case
    ref = np.asarray(_sequential(params, jnp.asarray(inputs["micro"])))
    mesh = make_mesh(4, axis_names=("pipe",))
    jax_out = np.asarray(jax.jit(
        lambda p, m: pipeline_apply(_stage_fn, p, m, mesh, axis="pipe")
    )(params, jnp.asarray(inputs["micro"])))
    for o in out:  # every stage holds the outputs
        np.testing.assert_allclose(o["fwd"], ref, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(o["fwd"], jax_out, rtol=2e-5, atol=1e-6)


def test_pipeline_gradients_match_sequential(case):
    inputs, params, out = case
    micro, tgt = jnp.asarray(inputs["micro2"]), jnp.asarray(inputs["tgt"])
    g_seq = jax.grad(lambda p: jnp.mean((_sequential(p, micro) - tgt) ** 2))(params)
    for o in out:
        for k in params:
            np.testing.assert_allclose(o["grads"][k], np.asarray(g_seq[k]),
                                       rtol=1e-4, atol=1e-6)


def test_pipeline_stage_params_actually_sharded(case):
    inputs, params, out = case
    ref = np.asarray(_sequential(params, jnp.asarray(inputs["micro3"])))
    for o in out:
        assert o["block_shape"] == (1, WIDTH, WIDTH)
        np.testing.assert_allclose(o["fwd_block"], ref, rtol=2e-5, atol=1e-6)


def test_pipeline_composes_with_data_parallelism(case):
    inputs, params, out = case
    two = {k: v[:2] for k, v in params.items()}
    micro = jnp.asarray(inputs["micro_dp"])
    ref = np.asarray(_sequential(two, micro, stages=2))
    mesh = make_mesh(4, axis_names=("data", "pipe"), shape=(2, 2))
    jax_out = np.asarray(jax.jit(lambda p, m: pipeline_apply(
        _stage_fn, p, m, mesh, axis="pipe", micro_spec=P(None, "data")))(
        two, jax.device_put(micro, NamedSharding(mesh, P(None, "data")))))
    for o in out:
        d = o["coords_dp"]["data"]
        np.testing.assert_allclose(o["fwd_dp"], ref[:, 2 * d:2 * d + 2],
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(o["fwd_dp"], jax_out[:, 2 * d:2 * d + 2],
                                   rtol=2e-5, atol=1e-6)


def test_pipeline_rejects_wrong_stage_count(case):
    _inputs, _params, out = case
    assert all("leading dim 4" in o["errors"]["stages"] for o in out)


def test_pipeline_rejects_pipe_axis_in_micro_spec(case):
    _inputs, _params, out = case
    assert all("pipe" in o["errors"]["micro_spec"] for o in out)


@pytest.fixture(scope="module")
def albert_pp(tmp_path_factory):
    w, b = weights(), batches()
    axes, shape = ("data", "pipe"), (2, 2)
    ref = jax_steps(axes, shape, w, b)
    outs = run_ranks(tmp_path_factory.mktemp("albert_pp"), 4, "albert_steps",
                     port_inputs(axes, shape, w, b))
    return ref, outs


def test_albert_shared_layer_pipelined(albert_pp):
    """ALBERT's one block staged over 2 ranks (1 application each of the
    tiny config's 2), 4 microbatches of each data shard's rows: the slice's
    losses, gradients and params after 2 steps as the JAX trainer's."""
    ref, outs = albert_pp
    assert_matches_jax(outs[0], ref)
    assert_replicas_bitwise(outs, ("data", "pipe"), (2, 2))
