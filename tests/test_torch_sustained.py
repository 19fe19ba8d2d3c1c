"""The port's longest parity run, and the reader of sustained runs.

Twenty global steps of the tiny ALBERT on word-corpus shards
(``tools/word_corpus.py``) through each package's ``run_trainer`` on the
CPU, from the same checkpoint (written by the port, read by both) and the
same batches (the peers' shuffling seed pinned alike): the per-step
losses of the two trajectories agree within ``TRAJ_ATOL``. Then
``tools/sustained.py`` reads such a run's train log: the curve, the
unigram-entropy mark, the launches per boundary."""
import json
import os
import shutil
import sysconfig

import numpy as np
import pytest

import dedloc_tpu.roles.trainer as jax_trainer
import dedloc_tpu_torch.roles.trainer as port_trainer
from dedloc_tpu.core.config import CollaborationArguments as JaxArguments
from dedloc_tpu.core.config import parse_config as jax_parse_config
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.parallel.train_step import TrainState
from dedloc_tpu_torch.roles.common import build_model, build_optimizer
from dedloc_tpu_torch.tools import sustained
from dedloc_tpu_torch.tools import word_corpus

STEPS = 20
SEQ, VOCAB = 32, 512
# bf16 on both sides (the tiny config's dtype): one step's loss may differ
# by 2e-2 (tests/test_torch_albert.py), but from one state and one batch
# the two packages' twenty steps stayed within 2e-4 of each other; ten
# times that leaves room for reordered sums and no room for a wrong step
TRAJ_ATOL = 2e-3


def _flags(out, corpus):
    return ["--dht.experiment_prefix", "trajectory", "--dht.listen_host", "127.0.0.1",
            "--training.model_size", "tiny", "--training.seq_length", str(SEQ),
            "--training.per_device_batch_size", "4",
            "--training.gradient_accumulation_steps", "2",
            "--training.learning_rate", "0.005", "--training.warmup_steps", "5",
            "--training.total_steps", "40",
            "--training.max_local_steps", str(2 * STEPS),
            "--training.save_steps", "0",
            "--training.dataset_path", os.path.join(corpus, "train"),
            "--training.output_dir", str(out / "out"),
            "--training.train_log_path", str(out / "train.jsonl"),
            "--optimizer.target_batch_size", "8",
            "--averager.metadata_expiration", "0.2",
            "--averager.min_refresh_period", "0.1",
            "--averager.default_refresh_period", "0.2",
            "--checkpoint.cache_dir", "none"]


def _records(out):
    with open(out / "train.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    root = tmp_path_factory.mktemp("trajectory")
    corpus = str(root / "corpus")
    report = word_corpus.build(corpus, SEQ, VOCAB, roots=[
        os.path.join(sysconfig.get_paths()["stdlib"], d) for d in ("json", "email")],
        max_docs=150)
    runs = {}
    for name in ("port", "jax"):
        (root / name).mkdir()
    # the same starting state for both: the port's seeded tiny model and a
    # fresh LAMB state, checkpointed at step 0 under the JAX names
    args = parse_config(CollaborationArguments, _flags(root / "port", corpus))
    _cfg, model = build_model("tiny", device="cpu", seed=0)
    tx = build_optimizer(args)
    port_trainer._save(args, TrainState.create(dict(model.named_parameters()), tx), 0, tx)
    shutil.copytree(root / "port" / "out", root / "jax" / "out")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("DEDLOC_FORCE_CPU", "1")
        # one shuffling seed for both peers: the same batches in the same order
        mp.setattr(port_trainer, "peer_shuffle_seed", lambda key: 1234)
        mp.setattr(jax_trainer, "peer_shuffle_seed", lambda key: 1234)
        port_trainer.run_trainer(args)
        jax_trainer.run_trainer(jax_parse_config(JaxArguments, _flags(root / "jax", corpus)))
    finally:
        mp.undo()
    for name in ("port", "jax"):
        runs[name] = _records(root / name)
    return runs, report, root


def test_both_packages_take_twenty_global_steps(trajectories):
    runs, _report, _root = trajectories
    for name, records in runs.items():
        assert [r["step"] for r in records] == list(range(1, STEPS + 1)), name


def test_per_step_losses_agree(trajectories):
    runs, _report, _root = trajectories
    port = np.array([r["loss"] for r in runs["port"]])
    ref = np.array([r["loss"] for r in runs["jax"]])
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(port, ref, atol=TRAJ_ATOL, rtol=0)
    assert port[-1] < port[0]  # it learns


def test_sustained_reads_the_run(trajectories):
    _runs, report, root = trajectories
    os.replace(root / "port" / "train.jsonl", root / "port" / "train_log_tpu.jsonl")
    out = sustained.summary(str(root / "port"), os.path.dirname(report["train"]["path"]))
    card = out["card"]
    assert card["steps"] == STEPS and card["finite"]
    assert card["unigram_entropy_nats"] == report["unigram_entropy_nats"]
    assert card["samples_per_step"] == 8
    # on the CPU no kernel launches: each wrapper counted 0 per boundary
    assert card["launches_per_boundary"] == {k: [0.0] for k in sustained.CARD_LAUNCHES}
    assert card["launches_as_expected"] is False
    mark = card["below_entropy"]
    losses = [r["mlm_loss"] for r in _records_renamed(root)]
    below = [i for i, x in enumerate(losses) if x < report["unigram_entropy_nats"]]
    assert mark["first_step"] == (below[0] + 1 if below else None)


def _plateau(tail):
    """A curve of 200 steps: 100 well above a mark of 6.0, then ``tail``."""
    losses = [7.0] * 100 + list(tail)
    return [{"step": i + 1, "wall_s": float(i), "loss": x, "mlm_loss": x, "samples": 8,
             "samples_per_second": 8.0, "boundaries": i + 1} for i, x in enumerate(losses)]


@pytest.mark.parametrize("tail, sustained_below", [
    # a plateau 0.04 above the mark whose 10-step mean dips below it once
    ([6.04] * 50 + [5.9] * 10 + [6.04] * 40, False),
    # the last 100 steps' mean below the mark
    ([5.98] * 100, True),
])
def test_the_mark_is_crossed_only_by_the_mean_of_the_last_steps(tail, sustained_below):
    mark = sustained.curve(_plateau(tail), 6.0, expected=None)["below_entropy"]
    assert mark["mean_of_10_step"] is not None
    assert mark["last_steps"] == 100
    assert mark["mean_of_last"] == pytest.approx(sum(tail) / 100)
    assert mark["sustained"] is sustained_below


def _records_renamed(root):
    with open(root / "port" / "train_log_tpu.jsonl") as f:
        return [json.loads(line) for line in f]


def test_matched_steps_of_two_logs(trajectories):
    _runs, _report, root = trajectories
    port = next(p for p in (root / "port" / "train.jsonl",
                            root / "port" / "train_log_tpu.jsonl") if p.exists())
    out = sustained.matched(str(port), str(root / "jax" / "train.jsonl"))
    assert out["steps"] == STEPS
    assert out["max_abs_loss_gap"] <= TRAJ_ATOL
    assert sorted(out["at_step"], key=int)[0] == "1"
