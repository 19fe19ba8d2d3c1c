"""A mixed swarm: one JAX peer and one torch peer average in the same
rounds over loopback, and a torch peer joining late loads a JAX peer's
params and optimizer state. Both sides carry the same wire names, shapes
and element order (``dedloc_tpu_torch/models/convert.py``), so the schema
handshake matches and the averaged bytes are the same on both peers."""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.collaborative.optimizer import CollaborativeOptimizer as JaxOptimizer
from dedloc_tpu.collaborative.optimizer import _tree_to_named
from dedloc_tpu.core.config import CollaborationArguments
from dedloc_tpu.dht import DHT as JaxDHT
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.models.albert import AlbertForPreTraining as JaxModel
from dedloc_tpu.parallel import train_step as jax_ts
from dedloc_tpu.roles import common as jax_common
from dedloc_tpu_torch.collaborative import CollaborativeOptimizer
from dedloc_tpu_torch.core.config import TrainingArguments
from dedloc_tpu_torch.dht import DHT
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.models.albert import AlbertConfig, AlbertForPreTraining
from dedloc_tpu_torch.parallel.train_step import (
    TrainState,
    make_accumulate_step,
    zeros_like_grads,
)
from dedloc_tpu_torch.roles.common import (
    build_flat_opt_factory,
    build_loss_fn,
    build_optimizer,
    drop_collator_keys,
    synthetic_mlm_batches,
)

RECIPE = dict(learning_rate=5e-3, warmup_steps=0, total_steps=100,
              weight_decay=0.01, max_grad_norm=1.0)
B, K = 2, 3  # micro-batch size, global steps
# the two peers' gradients come from two frameworks' forward and backward
# (fp32, reduction order differs); the averaged bytes are identical, so the
# params differ only by that and by the optimizers' own rounding
TOL = dict(atol=2e-5, rtol=2e-5)
OPT_KW = dict(
    compression="none",
    averaging_expiration=1.5,
    averaging_timeout=20.0,
    min_refresh_period=0.1,
    default_refresh_period=0.3,
    listen_host="127.0.0.1",
)


def _jax_args():
    args = CollaborationArguments()
    args.training = dataclasses.replace(args.training, **RECIPE)
    return args


@pytest.fixture(scope="module")
def jax_init():
    model = JaxModel(JaxConfig.tiny(dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((B, 32), jnp.int32))["params"]
    return model, params


def _micro(n):
    it = synthetic_mlm_batches(AlbertConfig.tiny(), B, 32, seed=3)
    return [next(it) for _ in range(n)]


def _record_averaged(opt, received):
    """Keep a copy of every averaged result the averager hands back."""
    step = opt.averager.step

    def recording(*args, **kwargs):
        averaged, group_size = step(*args, **kwargs)
        if averaged is not None:
            received.append(np.array(averaged.flat))
        return averaged, group_size

    opt.averager.step = recording


def _drive(opt, state, accumulate_one, micro_ids, deadline):
    """K global steps: one micro-batch per boundary, polled until the
    round lands. ``accumulate_one(state, grad_acc, n_acc, j)``."""
    grad_acc, n_acc = None, None
    k = 0
    while k < K and time.time() < deadline:
        grad_acc, n_acc = accumulate_one(state, grad_acc, n_acc, micro_ids[k])
        stepped, first = False, True
        while not stepped and time.time() < deadline:
            state, grad_acc, n_acc, stepped = opt.step(
                state, grad_acc, n_acc, samples=B if first else 0)
            first = False
            if not stepped:
                time.sleep(0.05)
        k = opt.local_step
    return state


def test_jax_and_torch_peers_average_in_the_same_rounds(jax_init):
    jmodel, params0 = jax_init
    micro = _micro(2 * K)
    named0 = _tree_to_named(params0)
    jdht = JaxDHT(start=True, listen_host="127.0.0.1")
    tdht = DHT(start=True, listen_host="127.0.0.1",
               initial_peers=[jdht.get_visible_address()])
    results, errors, received = {}, [], {"jax": [], "torch": []}
    deadline = time.time() + 90

    def jax_peer():
        try:
            args = _jax_args()
            tx = jax_common.build_optimizer(args)
            opt = JaxOptimizer(tx, jdht, "mixed", target_batch_size=2 * B,
                               flat_opt_factory=jax_common.build_flat_opt_factory(args),
                               **OPT_KW)
            _record_averaged(opt, received["jax"])
            acc = jax_ts.make_accumulate_step(jax_common.build_loss_fn(jmodel))

            def one(state, g, n, j):
                if g is None:
                    g, n = jax_ts.zeros_like_grads(state.params), jnp.zeros([], jnp.int32)
                g, n, _ = acc(state.params, g, n,
                              jax_common.drop_collator_keys(micro[j]),
                              jax.random.PRNGKey(j))
                return g, n

            state = jax_ts.TrainState.create(jax.tree.map(jnp.copy, params0), tx)
            state = _drive(opt, state, one, [2 * k for k in range(K)], deadline)
            results["jax"] = (_tree_to_named(jax.device_get(state.params)),
                              opt.local_step)
            opt.shutdown()
        except Exception as e:  # noqa: BLE001 — reported by the test thread
            errors.append(("jax", repr(e)))

    def torch_peer():
        try:
            model = AlbertForPreTraining(AlbertConfig.tiny(dtype=torch.float32))
            model.load_state_dict(convert.params_from_jax(named0))
            params = dict(model.named_parameters())
            targs = TrainingArguments(**RECIPE)
            tx = build_optimizer(targs)
            opt = CollaborativeOptimizer(tx, tdht, "mixed", target_batch_size=2 * B,
                                         flat_opt_factory=build_flat_opt_factory(targs),
                                         **OPT_KW)
            _record_averaged(opt, received["torch"])
            acc = make_accumulate_step(build_loss_fn(model))

            def one(state, g, n, j):
                if g is None:
                    g, n = zeros_like_grads(state.params), 0
                g, n, _ = acc(state.params, g, n,
                              drop_collator_keys(micro[j], device="cpu"))
                return g, n

            state = _drive(opt, TrainState.create(params, tx), one,
                           [2 * k + 1 for k in range(K)], deadline)
            results["torch"] = (convert.params_to_jax(state.params),
                                opt.local_step, opt.last_apply)
            opt.shutdown()
        except Exception as e:  # noqa: BLE001 — reported by the test thread
            errors.append(("torch", repr(e)))

    threads = [threading.Thread(target=f, daemon=True) for f in (jax_peer, torch_peer)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        (jparams, jsteps), (tparams, tsteps, tapply) = results["jax"], results["torch"]
        assert jsteps == tsteps == K
        assert tapply == "flat"
        # both peers received the same averaged bytes in every round
        assert len(received["jax"]) == len(received["torch"]) == K
        for a, b in zip(received["jax"], received["torch"]):
            assert a.tobytes() == b.tobytes()
        assert sorted(jparams) == sorted(tparams)
        for name, ref in jparams.items():
            np.testing.assert_allclose(tparams[name], ref, **TOL, err_msg=name)
    finally:
        tdht.shutdown()
        jdht.shutdown()


def test_late_torch_peer_loads_the_jax_peers_state_bitwise(jax_init):
    jmodel, params0 = jax_init
    micro = _micro(2)
    args = _jax_args()
    tx = jax_common.build_optimizer(args)
    jdht = JaxDHT(start=True, listen_host="127.0.0.1")
    jopt = JaxOptimizer(tx, jdht, "late", target_batch_size=B,
                        metadata_expiration=0.2, **OPT_KW)
    tdht = topt = None
    try:
        time.sleep(0.3)  # past the cold-start grace: the JAX peer steps solo
        acc = jax_ts.make_accumulate_step(jax_common.build_loss_fn(jmodel))
        state = jax_ts.TrainState.create(jax.tree.map(jnp.copy, params0), tx)

        def one(state, g, n, j):
            g, n = jax_ts.zeros_like_grads(state.params), jnp.zeros([], jnp.int32)
            g, n, _ = acc(state.params, g, n,
                          jax_common.drop_collator_keys(micro[j]), jax.random.PRNGKey(j))
            return g, n

        deadline = time.time() + 60
        for j in range(2):
            g, n = one(state, None, None, j)
            stepped = False
            while not stepped and time.time() < deadline:
                state, g, n, stepped = jopt.step(state, g, n, B)
                time.sleep(0.02)
        assert jopt.local_step == 2
        jopt._join_backup()  # the post-apply snapshot is being served
        shared = _tree_to_named(jax.device_get((state.params, state.opt_state)))

        tdht = DHT(start=True, listen_host="127.0.0.1",
                   initial_peers=[jdht.get_visible_address()])
        targs = TrainingArguments(**RECIPE)
        ttx = build_optimizer(targs)
        topt = CollaborativeOptimizer(ttx, tdht, "late", target_batch_size=B, **OPT_KW)
        model = AlbertForPreTraining(AlbertConfig.tiny(dtype=torch.float32))
        tstate = TrainState.create(dict(model.named_parameters()), ttx)
        tstate = topt.load_state_from_peers(tstate)
        assert topt.local_step == 2
        assert int(tstate.step) == int(state.step) == 2
        ours = convert.state_to_jax(tstate.params, tstate.opt_state, clip=True,
                                    schedule=True)
        assert sorted(ours) == sorted(shared)
        for name, ref in shared.items():
            assert ours[name].dtype == ref.dtype, name
            assert ours[name].tobytes() == np.asarray(ref).tobytes(), name
    finally:
        if topt is not None:
            topt.shutdown()
        if tdht is not None:
            tdht.shutdown()
        jopt.shutdown()
        jdht.shutdown()
