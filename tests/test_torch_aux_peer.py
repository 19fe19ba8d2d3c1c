"""The port's aux role beside a trainer peer (the analog of the JAX
package's ``tests/test_collaborative.py`` aux tests): with only a DHT
address, it bootstraps its gradient template from the trainer's shared
state and joins averaging rounds with zero weight."""
import threading
import time

import torch

from dedloc_tpu_torch.collaborative import CollaborativeOptimizer
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.dht import DHT
from dedloc_tpu_torch.optim.lamb import Lamb
from dedloc_tpu_torch.parallel.train_step import (
    TrainState,
    make_accumulate_step,
    zeros_like_grads,
)
from dedloc_tpu_torch.roles import aux


def _args(tmp_path, *extra):
    return parse_config(CollaborationArguments, [
        "--dht.listen_host", "127.0.0.1",
        "--training.model_size", "tiny",
        "--training.output_dir", str(tmp_path / "out"),
        "--averager.min_refresh_period", "0.1",
        "--averager.default_refresh_period", "0.3",
        *extra,
    ])


def _toy_loss(params, batch, rng=None):
    err = batch["x"] @ params["w"] - batch["y"]
    loss = (err * err).mean()
    return loss, {"loss": loss}


def test_aux_role_joins_a_round_with_a_trainer(tmp_path):
    """A trainer peer (port optimizer, a toy problem) and the port's aux
    role bootstrapping from it: the aux takes its template from the
    trainer's shared state and joins at least one averaging round."""
    trainer_dht = DHT(start=True, listen_host="127.0.0.1")
    tx = Lamb(0.05, weight_decay=0.0)
    opt = CollaborativeOptimizer(
        tx, trainer_dht, "torchaux", target_batch_size=32,
        averaging_expiration=1.5, averaging_timeout=20.0,
        min_refresh_period=0.1, default_refresh_period=0.3,
        metadata_expiration=30.0, listen_host="127.0.0.1")
    args = _args(tmp_path, "--dht.experiment_prefix", "torchaux",
                 "--dht.initial_peers", trainer_dht.get_visible_address(),
                 "--optimizer.target_batch_size", "32",
                 "--averager.averaging_expiration", "1.5")
    done, result = threading.Event(), {}

    def run():
        try:
            # 600 polls 0.1 s apart, at least 60 s (the JAX package's aux
            # test's deadline): the aux polls until the trainer's first
            # round, however late a loaded machine makes it, and stops once
            # it has joined one
            result["rounds"] = aux.run_aux(args, poll_interval=0.1,
                                           max_iterations=600, max_rounds=1)
        finally:
            done.set()

    params = {"w": torch.nn.Parameter(torch.full((2, 1), 0.5))}
    state = TrainState.create(params, tx)
    opt.seed_state_sharing(state)
    thread = threading.Thread(target=run)
    thread.start()
    acc = make_accumulate_step(_toy_loss)
    gen = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn(16, 2, generator=gen)}
    batch["y"] = batch["x"] @ torch.tensor([[1.0], [-1.0]])
    steps = 0
    try:
        deadline = time.time() + 90
        while not done.is_set() and time.time() < deadline:
            grad_acc, n, _ = acc(state.params, zeros_like_grads(state.params), 0,
                                 batch)
            state, _g, _n, stepped = opt.step(state, grad_acc, n, samples=16)
            steps += stepped
        thread.join(timeout=60)
    finally:
        opt.shutdown()
        trainer_dht.shutdown()
    assert steps >= 1
    assert result.get("rounds", 0) >= 1, "the aux never joined a round"
