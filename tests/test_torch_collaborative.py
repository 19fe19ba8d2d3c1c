"""The port's CollaborativeOptimizer: two torch peers over loopback emulate
one large-batch run (the analog of tests/test_equivalence.py for the
port), a solo peer steps alone through the flat apply on every route, and a
non-finite update rolls back."""
import threading
import time

import pytest
import torch

from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
from dedloc_tpu_torch.collaborative import CollaborativeOptimizer
from dedloc_tpu_torch.collaborative.optimizer import _fused_mean_clip
from dedloc_tpu_torch.collaborative.progress import CollaborationState
from dedloc_tpu_torch.core.config import TrainingArguments
from dedloc_tpu_torch.dht import DHT
from dedloc_tpu_torch.models.albert import (
    AlbertConfig,
    AlbertForPreTraining,
    init_weights,
)
from dedloc_tpu_torch.optim.flat import flat_twin
from dedloc_tpu_torch.parallel.train_step import (
    TrainState,
    make_accumulate_step,
    make_apply_step,
    make_flat_apply_step,
    zeros_like_grads,
)
from dedloc_tpu_torch.roles.common import (
    build_loss_fn,
    build_optimizer,
    drop_collator_keys,
    synthetic_mlm_batches,
)

# fp32 everywhere, compression "none": the two-peer run and the single
# large-batch run differ only in summation order (the all-reduce adds two
# fp32 halves; the single run adds the micro-batches in its accumulator)
TOL = dict(atol=2e-5, rtol=2e-5)
RECIPE = dict(learning_rate=5e-3, warmup_steps=0, total_steps=100,
              weight_decay=0.01, max_grad_norm=1.0)
B, K = 2, 3  # micro-batch size, global steps
OPT_KW = dict(
    compression="none",
    averaging_expiration=1.5,
    averaging_timeout=20.0,
    min_refresh_period=0.1,
    default_refresh_period=0.3,
    listen_host="127.0.0.1",
)


def _model(seed=0):
    model = AlbertForPreTraining(AlbertConfig.tiny(dtype=torch.float32))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def _micro(n):
    it = synthetic_mlm_batches(AlbertConfig.tiny(), B, 32, seed=3)
    return [drop_collator_keys(next(it), device="cpu") for _ in range(n)]


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _step_until_stepped(opt, state, grad_acc, n_acc, samples, timeout=20.0):
    """Report ``samples`` once, then poll until the global step lands."""
    deadline = time.time() + timeout
    state, grad_acc, n_acc, stepped = opt.step(state, grad_acc, n_acc, samples)
    while not stepped and time.time() < deadline:
        time.sleep(0.05)
        state, grad_acc, n_acc, stepped = opt.step(state, grad_acc, n_acc, 0)
    return state, stepped


@pytest.fixture(scope="module")
def single_run():
    """One peer, both micro-batches every step: the large-batch reference."""
    model = _model()
    params = dict(model.named_parameters())
    tx = build_optimizer(TrainingArguments(**RECIPE))
    state = TrainState.create(params, tx)
    accumulate = make_accumulate_step(build_loss_fn(model))
    apply = make_apply_step(tx)
    micro = _micro(2 * K)
    for k in range(K):
        g, n = zeros_like_grads(params), 0
        for j in (2 * k, 2 * k + 1):
            g, n, _ = accumulate(params, g, n, micro[j])
        state = apply(state, {name: v / n for name, v in g.items()})
    return _params(model)


def _run_peer(idx, dht, results, errors, prefix, micro):
    try:
        model = _model()
        params = dict(model.named_parameters())
        tx = build_optimizer(TrainingArguments(**RECIPE))
        opt = CollaborativeOptimizer(tx, dht, prefix, target_batch_size=2 * B,
                                     **OPT_KW)
        state = TrainState.create(params, tx)
        accumulate = make_accumulate_step(build_loss_fn(model))
        grad_acc, n_acc = zeros_like_grads(params), 0
        deadline = time.time() + 60
        k = 0
        while k < K and time.time() < deadline:
            j = 2 * k + idx  # peer 0 takes the even micro-batches, peer 1 odd
            grad_acc, n_acc, _ = accumulate(params, grad_acc, n_acc, micro[j])
            stepped, first = False, True
            while not stepped and time.time() < deadline:
                # report the B fresh samples once; retries while the round
                # assembles must not inflate the progress count
                state, grad_acc, n_acc, stepped = opt.step(
                    state, grad_acc, n_acc, samples=B if first else 0)
                first = False
                if not stepped:
                    time.sleep(0.05)
            k = opt.local_step
        results[idx] = (_params(model), opt.local_step, opt.last_apply,
                        opt.last_group_size, opt._pipeline is not None)
        opt.shutdown()
    except Exception as e:  # noqa: BLE001 — reported by the test thread
        errors.append((idx, repr(e)))


def test_two_torch_peers_match_one_large_batch(single_run):
    micro = _micro(2 * K)
    first = DHT(start=True, listen_host="127.0.0.1")
    second = DHT(start=True, listen_host="127.0.0.1",
                 initial_peers=[first.get_visible_address()])
    results, errors = {}, []
    threads = [
        threading.Thread(target=_run_peer, daemon=True,
                         args=(i, d, results, errors, "torch-equiv", micro))
        for i, d in ((0, first), (1, second))
    ]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert set(results) == {0, 1}
        for idx in (0, 1):
            params, steps, apply, group, device_flat = results[idx]
            assert steps == K, f"peer {idx} finished {steps}/{K} steps"
            assert (apply, group, device_flat) == ("flat", 2, True)
            for name, ref in single_run.items():
                torch.testing.assert_close(params[name], ref, **TOL, msg=name)
        # every replica applied the identical averaged bytes
        for name in single_run:
            assert torch.equal(results[0][0][name], results[1][0][name]), name
    finally:
        second.shutdown()
        first.shutdown()


def _fail_every_round(opt):
    """Partners reported at our step, but no round ever lands: after its
    retries the peer applies its own mean gradients (local-apply fallback)."""
    at_step = CollaborationState(
        optimizer_step=0, samples_accumulated=2 * B, target_batch_size=B,
        num_peers=2, num_clients=0, eta_next_step=0.0, next_fetch_time=0.0,
        num_aux=0, num_peers_at_step=2, num_peers_near_step=2)
    opt.tracker.fetch_collaboration_state = lambda force=False: at_step
    opt.averager.step = lambda *args, **kwargs: (None, 1)


@pytest.mark.parametrize("route", ["alone", "in_grace", "fallback"])
def test_solo_peer_steps_alone_through_the_flat_apply(route):
    """A peer with no partner applies its own mean gradients through the
    flat apply on every route: alone past the grace period (no round),
    within it (a round of one), and on the local-apply fallback after its
    failed rounds. The result is the per-leaf chain's within float32
    reduction order, and bitwise the flat apply built directly."""
    model = _model()
    params = dict(model.named_parameters())
    tx = build_optimizer(TrainingArguments(**RECIPE))
    dht = DHT(start=True, listen_host="127.0.0.1")
    opt = CollaborativeOptimizer(
        tx, dht, f"torch-solo-{route}", target_batch_size=B,
        metadata_expiration=30.0 if route == "in_grace" else 0.2, **OPT_KW)
    try:
        if route == "fallback":
            _fail_every_round(opt)
        else:
            time.sleep(0.3)  # past the cold-start grace, if it is 0.2 s
        state = TrainState.create(params, tx)
        accumulate = make_accumulate_step(build_loss_fn(model))
        micro = _micro(2)
        ref = _model()
        ref_params = dict(ref.named_parameters())
        ref_state = TrainState.create(ref_params, tx)
        g, n = zeros_like_grads(params), 0
        g, n, _ = accumulate(params, g, n, micro[0])
        state, stepped = _step_until_stepped(opt, state, g, n, B)
        assert stepped and opt.local_step == 1
        assert (opt.last_apply, opt.last_group_size) == ("flat", 1)
        # the boundary crossed the device-flat seam unless it stepped alone
        assert ("grads_device_get" in opt.seam_ms) == (route != "alone")
        assert int(state.step) == 1 and int(state.opt_state.count) == 1
        rg, rn, _ = make_accumulate_step(build_loss_fn(ref))(
            ref_params, zeros_like_grads(ref_params), 0, micro[0])
        make_apply_step(tx)(ref_state, {k: v / rn for k, v in rg.items()})
        for name in params:
            torch.testing.assert_close(params[name], ref_params[name],
                                       atol=1e-6, rtol=1e-6, msg=name)
        flat = _model()
        flat_params = dict(flat.named_parameters())
        mean = _fused_mean_clip(rg, rn, 0.0)
        spec = DeviceFlatPipeline.for_tree(mean).spec
        make_flat_apply_step(flat_twin(tx, spec, flat_params), spec, from_tree=True)(
            TrainState.create(flat_params, tx), mean)
        for name in params:
            assert torch.equal(params[name], flat_params[name]), name
    finally:
        opt.shutdown()
        dht.shutdown()


def test_non_finite_update_rolls_back_bitwise():
    """NaN gradients: the apply rejects the update on the card; params,
    moments, counts and step come back bitwise, and the next boundary
    reads the verdict."""
    model = _model()
    params = dict(model.named_parameters())
    args = TrainingArguments(**RECIPE)
    tx = build_optimizer(args)
    dht = DHT(start=True, listen_host="127.0.0.1")
    opt = CollaborativeOptimizer(
        tx, dht, "torch-nan", target_batch_size=B, metadata_expiration=0.2,
        **OPT_KW)
    try:
        time.sleep(0.3)
        state = TrainState.create(params, tx)
        before = _params(model)
        nan = {k: torch.full_like(p, float("nan")) for k, p in params.items()}
        state, stepped = _step_until_stepped(opt, state, nan, 1, B)
        assert stepped
        assert opt._pending_apply_ok is not None
        assert not bool(opt._pending_apply_ok[1])
        for name, p in params.items():
            assert torch.equal(p.detach(), before[name]), name
        for moments in (state.opt_state.mu, state.opt_state.nu):
            assert all(not m.any() for m in moments.values())
        assert int(state.step) == 0 and int(state.opt_state.count) == 0
        assert int(state.opt_state.schedule_count) == 0
        opt._check_apply_ok()
        assert opt._pending_apply_ok is None
    finally:
        opt.shutdown()
        dht.shutdown()
