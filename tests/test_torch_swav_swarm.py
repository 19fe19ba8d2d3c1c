"""A mixed SwAV swarm: one JAX peer and one torch peer (the tiny config,
bf16 trunks as the roles build them) average their gradients in the same
rounds over loopback and apply them through each package's flat LARS apply
with the prototype re-normalisation; both receive the same averaged bytes
every round and hold the same params after every common step."""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.collaborative.optimizer import CollaborativeOptimizer as JaxOptimizer
from dedloc_tpu.collaborative.optimizer import _named_to_tree, _tree_to_named
from dedloc_tpu.core.config import SwAVCollaborationArguments as JaxArgs
from dedloc_tpu.data.multicrop import MultiCropSpec as JaxSpec
from dedloc_tpu.dht import DHT as JaxDHT
from dedloc_tpu.models import swav as jswav
from dedloc_tpu.optim.lars import lars as jax_lars
from dedloc_tpu.optim.schedules import linear_warmup_cosine_annealing as jax_cosine
from dedloc_tpu.parallel import train_step as jax_ts
from dedloc_tpu.roles import swav as jax_role
from dedloc_tpu_torch.collaborative import CollaborativeOptimizer
from dedloc_tpu_torch.core.config import SwAVTrainingArguments
from dedloc_tpu_torch.data.multicrop import MultiCropSpec, synthetic_multicrop_batches
from dedloc_tpu_torch.dht import DHT
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models import swav
from dedloc_tpu_torch.models.resnet import init_batch_stats, init_weights
from dedloc_tpu_torch.optim.lars import Lars
from dedloc_tpu_torch.optim.schedules import linear_warmup_cosine_annealing
from dedloc_tpu_torch.parallel.train_step import TrainState, zeros_like_grads
from dedloc_tpu_torch.roles.swav import _build_flat_lars_factory

RECIPE = dict(learning_rate=0.3, warmup_steps=0, total_steps=100, momentum=0.9,
              weight_decay=1e-6, trust_coefficient=0.001)
B, K = 4, 3  # images per micro-batch, global steps
# both peers apply the SAME averaged bytes to the same params; they differ
# only by the two flat LARS applies' reduction order: 1e-5 relative, 1e-6
# absolute after each step
TOL = dict(rtol=1e-5, atol=1e-6)
OPT_KW = dict(
    compression="none",
    averaging_expiration=1.5,
    averaging_timeout=20.0,
    min_refresh_period=0.1,
    default_refresh_period=0.3,
    listen_host="127.0.0.1",
)


@pytest.fixture
def one_torch_thread():
    """The two peers compute concurrently in one process: one intra-op
    thread for torch beside XLA's CPU runtime (see
    ``tests/test_torch_swav_ckpt.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _record_averaged(opt, received):
    step = opt.averager.step

    def recording(*args, **kwargs):
        averaged, group_size = step(*args, **kwargs)
        if averaged is not None:
            received.append(np.array(averaged.flat))
        return averaged, group_size

    opt.averager.step = recording


def _drive(opt, state, accumulate_one, snapshot, trajectory, deadline):
    """K global steps, one micro-batch per boundary, polled until the round
    lands; ``trajectory[step] = snapshot(state)`` after each."""
    grad_acc, n_acc = None, None
    while opt.local_step < K and time.time() < deadline:
        grad_acc, n_acc = accumulate_one(state, grad_acc, n_acc)
        stepped, first = False, True
        while not stepped and time.time() < deadline:
            state, grad_acc, n_acc, stepped = opt.step(
                state, grad_acc, n_acc, samples=B if first else 0)
            first = False
            if not stepped:
                time.sleep(0.05)
        trajectory[opt.local_step] = snapshot(state)
    return state


def test_jax_and_torch_swav_peers_average_in_the_same_rounds(one_torch_thread):
    jcfg, tcfg = jswav.SwAVConfig.tiny(), swav.SwAVConfig.tiny()
    jmodel = jswav.SwAVModel(jcfg)
    model = init_weights(swav.SwAVModel(tcfg), torch.Generator().manual_seed(0))
    stats0 = init_batch_stats(model)
    crops0 = [jnp.zeros((c * B, s, s, 3)) for s, c in zip(JaxSpec.tiny().sizes,
                                                         JaxSpec.tiny().counts)]
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), crops0, True))
    jparams0 = _named_to_tree(convert.params_to_jax(dict(model.named_parameters())),
                              shapes["params"])
    jstats0 = _named_to_tree(convert.params_to_jax(stats0), shapes["batch_stats"])
    jdht = JaxDHT(start=True, listen_host="127.0.0.1")
    tdht = DHT(start=True, listen_host="127.0.0.1",
               initial_peers=[jdht.get_visible_address()])
    trajectories, errors, received = {"jax": {}, "torch": {}}, [], {"jax": [], "torch": []}
    last_apply = {}
    deadline = time.time() + 150

    def jax_peer():
        try:
            t = dataclasses.replace(JaxArgs().training, **RECIPE)
            tx = jax_lars(jax_cosine(t.learning_rate, t.warmup_steps, t.total_steps),
                          momentum=t.momentum, weight_decay=t.weight_decay,
                          trust_coefficient=t.trust_coefficient)
            opt = JaxOptimizer(tx, jdht, "swav-mixed", target_batch_size=2 * B,
                               flat_opt_factory=jax_role._build_flat_lars_factory(t),
                               post_apply=jswav.make_prototype_post_apply(), **OPT_KW)
            _record_averaged(opt, received["jax"])
            acc = jswav.make_swav_accumulate_step(jmodel, jcfg)
            batches = synthetic_multicrop_batches(MultiCropSpec.tiny(), B, seed=3)
            local = {"bs": jstats0}

            def one(state, g, n):
                if g is None:
                    g, n = jax_ts.zeros_like_grads(state.params), jnp.zeros([], jnp.int32)
                g, n, local["bs"], _q, _m = acc(
                    state.params, local["bs"], None, g, n,
                    [jnp.asarray(c) for c in next(batches)],
                    jnp.asarray(opt.local_step, jnp.int32), False)
                return g, n

            state = jax_ts.TrainState.create(jax.tree.map(jnp.copy, jparams0), tx)
            _drive(opt, state, one,
                   lambda s: _tree_to_named(jax.device_get(s.params)),
                   trajectories["jax"], deadline)
            opt.shutdown()
        except Exception as e:  # noqa: BLE001 — reported by the test thread
            errors.append(("jax", repr(e)))

    def torch_peer():
        try:
            t = SwAVTrainingArguments(**RECIPE)
            tx = Lars(linear_warmup_cosine_annealing(t.learning_rate, t.warmup_steps,
                                                     t.total_steps),
                      momentum=t.momentum, weight_decay=t.weight_decay,
                      trust_coefficient=t.trust_coefficient)
            opt = CollaborativeOptimizer(tx, tdht, "swav-mixed", target_batch_size=2 * B,
                                         flat_opt_factory=_build_flat_lars_factory(t),
                                         post_apply=swav.make_prototype_post_apply(),
                                         **OPT_KW)
            _record_averaged(opt, received["torch"])
            acc = swav.make_swav_accumulate_step(model, tcfg)
            batches = synthetic_multicrop_batches(MultiCropSpec.tiny(), B, seed=4)
            local = {"bs": stats0}

            def one(state, g, n):
                if g is None:
                    g, n = zeros_like_grads(state.params), 0
                g, n, local["bs"], _q, _m = acc(
                    state.params, local["bs"], None, g, n,
                    [torch.from_numpy(c) for c in next(batches)], opt.local_step, False)
                return g, n

            state = TrainState.create(dict(model.named_parameters()), tx)
            _drive(opt, state, one, lambda s: convert.params_to_jax(s.params),
                   trajectories["torch"], deadline)
            last_apply["torch"] = opt.last_apply
            opt.shutdown()
        except Exception as e:  # noqa: BLE001 — reported by the test thread
            errors.append(("torch", repr(e)))

    threads = [threading.Thread(target=f, daemon=True) for f in (jax_peer, torch_peer)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=200)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        assert last_apply["torch"] == "flat"
        assert len(received["jax"]) == len(received["torch"]) == K
        for a, b in zip(received["jax"], received["torch"]):
            assert a.tobytes() == b.tobytes()
        assert sorted(trajectories["jax"]) == sorted(trajectories["torch"]) == list(
            range(1, K + 1))
        for step in range(1, K + 1):
            ours, theirs = trajectories["torch"][step], trajectories["jax"][step]
            assert sorted(ours) == sorted(theirs)
            for name, ref in theirs.items():
                np.testing.assert_allclose(ours[name], ref, **TOL,
                                           err_msg=f"step {step} {name}")
            w = ours["['head']['prototypes0']['kernel']"]
            np.testing.assert_allclose(np.linalg.norm(w, axis=0), 1.0, atol=1e-6)
    finally:
        tdht.shutdown()
        jdht.shutdown()
