"""Background averaging (``--optimizer.overlap_averaging``) on the port's
CollaborativeOptimizer: ``tests/test_overlap.py``'s six scenarios, with the
same stub averager (a round held in flight for as many boundaries as the
scenario needs, then resolved or failed on demand) and the same real DHT
facade: accumulation during a delayed round, the result applied one
boundary late with the in-flight accumulation kept, the retry ladder reset
by a landed round, the restore of a failed round and the synchronous
fallback, overlap gated off during ramp, health gate and resync, and the
error-feedback settle rules of singleton rounds on the device pipeline and
the legacy host path."""
import concurrent.futures

import numpy as np
import pytest
import torch

from dedloc_tpu_torch.collaborative import CollaborativeOptimizer
from dedloc_tpu_torch.collaborative.progress import CollaborationState
from dedloc_tpu_torch.dht import DHT
from dedloc_tpu_torch.optim.lamb import Lamb
from dedloc_tpu_torch.parallel.train_step import TrainState, zeros_like_grads

pytestmark = pytest.mark.wirepath


def _collab(step=0, ready=True, peers=2, at_step=None):
    return CollaborationState(
        optimizer_step=step,
        samples_accumulated=100 if ready else 0,
        target_batch_size=32,
        num_peers=peers,
        num_clients=0,
        eta_next_step=0.0,
        next_fetch_time=0.0,
        num_aux=0,
        num_peers_at_step=peers if at_step is None else at_step,
        num_peers_near_step=peers,
    )


class StubAverager:
    """Drop-in recorder for DecentralizedAverager.step: overlap launches
    (return_future=True) get a future the TEST resolves; synchronous calls
    pop preloaded results."""

    def __init__(self, real):
        self._real = real
        self.calls = []
        self.pending = None
        self.sync_results = []

    def __call__(self, tree, weight, round_id, return_future=False,
                 expected_size=None, window=None):
        if hasattr(tree, "result") and not isinstance(tree, dict):
            # a device-flat contribution (FlatFetch): resolved as the real
            # averager does, so the stub sees the decoded FlatTree
            tree = tree.result()
        self.calls.append({"tree": tree, "weight": weight, "round_id": round_id,
                           "return_future": return_future})
        if return_future:
            assert self.pending is None, "one in-flight round at a time"
            self.pending = concurrent.futures.Future()
            return self.pending
        result = self.sync_results.pop(0)
        if result == "ECHO_SINGLETON":
            # a group of one: the contribution handed back verbatim
            self._real.last_contributors = 1
            return tree, 1
        self._real.last_contributors = 2
        return result

    def resolve(self, value, contributors=2):
        self._real.last_contributors = contributors
        fut, self.pending = self.pending, None
        fut.set_result(value)


def quarter(tree):
    """The averaged result a stub round lands: 0.25 everywhere."""
    return {k: np.full_like(np.asarray(v), 0.25) for k, v in tree.items()}


def stub_optimizer(tx, **kw):
    """(optimizer, stub averager, holder) on a real DHT, its tracker and
    averager replaced (``holder["state"]`` is the collaboration it sees)."""
    dht = DHT(start=True, listen_host="127.0.0.1")
    opt = CollaborativeOptimizer(
        tx, dht, "ovl", target_batch_size=32, averaging_expiration=0.5,
        averaging_timeout=5.0, allow_state_sharing=False,
        overlap_averaging=True, listen_host="127.0.0.1", **kw)
    holder = {"state": _collab(), "reports": []}
    opt.tracker.fetch_collaboration_state = lambda force=False: holder["state"]
    opt.tracker.report_local_progress = holder["reports"].append
    stub = StubAverager(opt.averager)
    opt.averager.step = stub
    return opt, stub, holder, dht


@pytest.fixture
def overlap_opt():
    opt, stub, holder, dht = stub_optimizer(Lamb(0.05, weight_decay=0.0))
    try:
        yield opt, stub, holder
    finally:
        opt.shutdown()
        dht.shutdown()


def _fresh(opt):
    params = {"w": torch.tensor([[0.5], [0.5]])}
    state = TrainState.create(params, opt.tx)
    before = {k: v.clone() for k, v in params.items()}
    return state, before, {"w": torch.ones(2, 1)}


def test_overlap_accumulates_in_flight_and_applies_one_boundary_late(overlap_opt):
    opt, stub, holder = overlap_opt
    state, params, ones = _fresh(opt)

    # boundary 1: target reached -> the round is LAUNCHED, not awaited
    state, grad_acc, n_acc, stepped = opt.step(state, ones, 1, samples=16)
    assert not stepped
    assert stub.calls and stub.calls[-1]["return_future"]
    assert stub.pending is not None and opt._overlap_inflight is not None
    assert opt.local_samples_accumulated == 0  # committed to the round
    assert n_acc == 0 and float(grad_acc["w"].abs().sum()) == 0.0
    assert stub.calls[-1]["weight"] == 16.0

    # boundaries 2..3: the round is still in flight; accumulation goes on
    acc = {"w": 2.0 * torch.ones(2, 1)}
    for _ in range(2):
        state, acc, n_acc, stepped = opt.step(state, acc, 1, samples=8)
        assert not stepped
    assert opt.local_samples_accumulated == 16
    assert len(stub.calls) == 1, "no second round while one is in flight"
    np.testing.assert_allclose(acc["w"].numpy(), 2.0 * np.ones((2, 1)))
    # the committed samples stay advertised while the round is in flight
    assert holder["reports"][-1].samples_accumulated == 16 + 16

    # the delayed round lands -> applied ONE boundary late, the flight's
    # accumulation kept
    stub.resolve((quarter(stub.calls[0]["tree"]), 2))
    state, acc, n_acc, stepped = opt.step(state, acc, 1, samples=8)
    assert stepped
    assert opt.local_step == 1 and int(state.step) == 1
    assert opt.local_samples_accumulated == 24  # 16 + 8, not reset
    np.testing.assert_allclose(acc["w"].numpy(), 2.0 * np.ones((2, 1)))
    assert not torch.allclose(state.params["w"], params["w"]), \
        "the averaged update must have been applied"


def test_overlap_success_resets_round_failure_ladder(overlap_opt):
    opt, stub, _holder = overlap_opt
    state, _params, ones = _fresh(opt)
    state, grad_acc, n_acc, stepped = opt.step(state, ones, 1, samples=16)
    assert stub.pending is not None
    opt._round_failures = opt.max_round_retries  # stale ladder state
    stub.resolve((quarter(stub.calls[0]["tree"]), 2))
    state, grad_acc, n_acc, stepped = opt.step(state, ones, 1, samples=8)
    assert stepped, "the landed round must apply at this boundary"
    assert opt._round_failures == 0


def test_overlap_failure_restores_grads_and_falls_back_sync(overlap_opt):
    opt, stub, holder = overlap_opt
    state, params, ones = _fresh(opt)
    state, grad_acc, n_acc, stepped = opt.step(state, ones, 1, samples=16)
    assert stub.pending is not None

    # the in-flight round fails; the fallback boundary's synchronous round
    # fails too -> the (restored) gradients are kept for a retry
    stub.resolve((None, 2))
    stub.sync_results.append((None, 2))
    state, grad_acc, n_acc, stepped = opt.step(state, zeros_like_grads(params), 0,
                                               samples=0)
    assert not stepped
    assert opt._overlap_cooldown, "failed overlap must cool down to sync"
    assert len(stub.calls) == 2 and not stub.calls[-1]["return_future"]
    np.testing.assert_allclose(grad_acc["w"].numpy(), np.ones((2, 1)), atol=1e-6)
    assert n_acc == 1
    assert opt.local_samples_accumulated == 16
    torch.testing.assert_close(state.params["w"], params["w"], rtol=0, atol=0)

    # the synchronous retry succeeds -> the step applies and overlap re-arms
    stub.sync_results.append((quarter(stub.calls[-1]["tree"]), 2))
    state, grad_acc, n_acc, stepped = opt.step(state, grad_acc, n_acc, samples=0)
    assert stepped and opt.local_step == 1
    assert not stub.calls[-1]["return_future"]
    assert not opt._overlap_cooldown

    holder["state"] = _collab(step=1)
    state, grad_acc, n_acc, stepped = opt.step(state, {"w": torch.ones(2, 1)}, 1,
                                               samples=16)
    assert not stepped and stub.calls[-1]["return_future"], \
        "a successful step must re-arm overlap"


def test_overlap_gated_off_during_ramp_health_gate_and_resync(overlap_opt):
    opt, stub, _holder = overlap_opt
    opt.ramp_rounds = 5
    opt._rounds_since_join = 2
    assert not opt._overlap_allowed(1.0)
    opt._rounds_since_join = 5
    assert opt._overlap_allowed(1.0)
    assert not opt._overlap_allowed(0.0)  # health gate
    opt._desynced = True
    assert not opt._overlap_allowed(1.0)
    opt._desynced = False
    opt._overlap_cooldown = True
    assert not opt._overlap_allowed(1.0)
    opt._overlap_cooldown = False

    # with the ramp active, a ready boundary averages synchronously, at a
    # ramped weight
    opt.ramp_rounds = 3
    opt._rounds_since_join = 0
    state, _params, ones = _fresh(opt)
    stub.sync_results.append(({"['w']": np.full((2, 1), 0.25, np.float32)}, 2))
    state, grad_acc, n_acc, stepped = opt.step(state, ones, 1, samples=16)
    assert stepped
    assert len(stub.calls) == 1 and not stub.calls[-1]["return_future"]
    ramped = CollaborativeOptimizer.ramp_fraction(0, 3)
    assert stub.calls[-1]["weight"] == pytest.approx(16.0 * ramped)


def test_singleton_round_commits_device_quantization_residual(overlap_opt):
    opt, stub, holder = overlap_opt
    opt.overlap_averaging = False  # the synchronous path
    assert opt.error_feedback.enabled  # float16 default
    state, _params, _ones = _fresh(opt)
    stub.sync_results.append(({"['w']": np.full((2, 1), 0.25, np.float32)}, 2))
    state, grad_acc, n_acc, stepped = opt.step(
        state, {"w": torch.full((2, 1), 1.0 / 3.0)}, 1, samples=16)
    assert stepped
    assert opt._pipeline is not None, "device pipeline must be active"
    assert opt._pipeline.residual_norm() > 0
    assert opt.error_feedback.residual_norm() == 0.0  # the device owns it

    # a singleton round's echo is the dequantized device form: it commits
    holder["state"] = _collab(step=1, at_step=1)
    stub.sync_results.append("ECHO_SINGLETON")
    state, grad_acc, n_acc, stepped = opt.step(
        state, {"w": torch.full((2, 1), 1.0 / 3.0)}, 1, samples=16)
    assert stepped
    assert opt._pipeline.residual_norm() > 0


def test_singleton_round_consumes_residual_on_legacy_host_path(overlap_opt):
    opt, stub, holder = overlap_opt
    opt.overlap_averaging = False
    opt.device_flat = False  # the legacy per-leaf host seam
    assert opt.error_feedback.enabled
    state, _params, _ones = _fresh(opt)
    stub.sync_results.append(({"['w']": np.full((2, 1), 0.25, np.float32)}, 2))
    state, grad_acc, n_acc, stepped = opt.step(
        state, {"w": torch.full((2, 1), 1.0 / 3.0)}, 1, samples=16)
    assert stepped
    assert opt.error_feedback.residual_norm() > 0

    # a singleton's verbatim echo crossed no wire: the residual resets
    holder["state"] = _collab(step=1, at_step=1)
    stub.sync_results.append("ECHO_SINGLETON")
    state, grad_acc, n_acc, stepped = opt.step(
        state, {"w": torch.full((2, 1), 1.0 / 3.0)}, 1, samples=16)
    assert stepped
    assert opt.error_feedback.residual_norm() == 0.0
