"""The port's SwAV accumulate step on a data-parallel slice of 2 and 4
gloo ranks against JAX's ``make_swav_accumulate_step(..., mesh=
make_mesh(N))`` on the CPU's virtual devices, from the same weights,
crops and queue (tiny config, fp32 trunk, two micro-batches with the queue
on: the no-queue sinkhorn is ``tests/test_torch_swav_mesh.py``'s): the
slice's loss, the gradient sums over the ranks, the running
statistics and the queue after each micro-batch, and every rank holding
bitwise the same statistics, queue and gradient sums."""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from dedloc_tpu.collaborative.optimizer import _tree_to_named
from dedloc_tpu.parallel.mesh import make_mesh
from test_torch_swav import _fp32_cfg, _pair, jax_batches, jax_zeros, jswav, JaxSpec
from torch_mesh_ranks import run_ranks

# the JAX package's own limits for its 8-device step against one device
# (tests/test_swav.py): the loss within 1e-4, gradients within 1e-3
# absolute and relative; the running statistics and the queue's fresh rows
# within 1e-5 (fp32, the slice's sums in another order)
LOSS_ATOL = 1e-4
GRAD_TOL = dict(atol=1e-3, rtol=1e-3)
STATS_ATOL = 1e-5
BATCH, QUEUE, SEED = 8, 16, 0
WORLDS = (2, 4)


def _inputs():
    it = jax_batches(JaxSpec.tiny(), BATCH, seed=11)
    micro = [(next(it), True), (next(it), True)]
    queue = np.asarray(jswav.SwAVQueue.create(
        _fp32_cfg(True, queue_length=QUEUE), jax.random.PRNGKey(5)).embeddings)
    return dict(micro=micro, queue=queue, batch=BATCH, seed=SEED)


def _jax_steps(world, inputs):
    jcfg = _fp32_cfg(True, queue_length=QUEUE)
    jmodel, variables, _model, _stats = _pair(jcfg, _fp32_cfg(False, queue_length=QUEUE),
                                              seed=SEED)
    mesh = make_mesh(world)
    step = jswav.make_swav_accumulate_step(jmodel, jcfg, mesh=mesh, num_crop_groups=2)
    data, repl = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    # placed as the step returns them, so the second call reuses the first
    # compilation
    params, ga, n, bs, queue = jax.device_put(
        (variables["params"], jax_zeros(variables["params"]), jnp.zeros([], jnp.int32),
         variables["batch_stats"], jswav.SwAVQueue(jnp.asarray(inputs["queue"]))), repl)
    step_no = jax.device_put(jnp.zeros([], jnp.int32), repl)
    out = {"losses": [], "stats": [], "queues": []}
    for crops, use_queue in inputs["micro"]:
        arrays = [jax.device_put(jnp.asarray(c), data) for c in crops]
        ga, n, bs, queue, metrics = step(params, bs, queue, ga, n, arrays, step_no,
                                         use_queue)
        out["losses"].append(float(metrics["loss"]))
        out["stats"].append(_tree_to_named(jax.device_get(bs)))
        out["queues"].append(np.asarray(queue.embeddings))
    out["grads"] = _tree_to_named(jax.device_get(ga))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both slices' ranks run while the JAX references compile."""
    inputs, ranks = _inputs(), {}
    paths = {w: tmp_path_factory.mktemp(f"swav{w}") for w in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {w: pool.submit(run_ranks, paths[w], w, "swav_steps", inputs)
                   for w in WORLDS}
        refs = {w: _jax_steps(w, inputs) for w in WORLDS}
        ranks = {w: f.result() for w, f in futures.items()}
    return lambda world: (refs[world], ranks[world])


@pytest.mark.parametrize("world", WORLDS)
def test_slice_loss_and_gradient_sums_match_jax(runs, world):
    ref, outs = runs(world)
    for o in outs:  # the slice's loss on every rank
        np.testing.assert_allclose(o["losses"], ref["losses"], atol=LOSS_ATOL, rtol=0)
    got = outs[0]["grads"]
    assert sorted(got) == sorted(ref["grads"])
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(got[name], want, err_msg=name, **GRAD_TOL)
    assert outs[0]["n"] == 2


@pytest.mark.parametrize("world", WORLDS)
def test_slice_running_stats_and_queue_match_jax(runs, world):
    ref, outs = runs(world)
    inputs = _inputs()
    for i in range(2):
        got = outs[0]["stats"][i]
        assert sorted(got) == sorted(ref["stats"][i])
        for name, want in ref["stats"][i].items():
            np.testing.assert_allclose(got[name], want, atol=STATS_ATOL, rtol=0,
                                       err_msg=f"micro-batch {i} {name}")
        q = outs[0]["queues"][i]
        np.testing.assert_allclose(q, ref["queues"][i], atol=STATS_ATOL, rtol=0)
        # the slice's rows shifted in, the rest shifted exactly
        prev = inputs["queue"] if i == 0 else outs[0]["queues"][0]
        np.testing.assert_array_equal(q[:, BATCH:], prev[:, :QUEUE - BATCH])


@pytest.mark.parametrize("world", WORLDS)
def test_slice_replicas_bitwise_equal(runs, world):
    _ref, outs = runs(world)
    for key in ("digests", "grads_digest", "losses"):
        assert all(o[key] == outs[0][key] for o in outs), key
