"""The port's SwAV peer (``python -m dedloc_tpu_torch.roles.swav``) on the
CPU at the tiny config, as ``tests/test_trainer.py`` holds the JAX one: it
takes global steps through the flat LARS apply, engages the queue, writes
a checkpoint and resumes from it; and its shared state and gradient wire
carry the JAX SwAV peer's names, shapes, dtypes and fingerprints. Its
checkpoints across packages: ``tests/test_torch_swav_ckpt.py``."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.averaging.averager import schema_fingerprint, spec_fingerprint
from dedloc_tpu.averaging.device_flat import DeviceFlatPipeline as JaxPipeline
from dedloc_tpu.core.config import SwAVCollaborationArguments as JaxArgs
from dedloc_tpu.core.config import parse_config as jax_parse
from dedloc_tpu.data.multicrop import MultiCropSpec as JaxSpec
from dedloc_tpu.parallel.train_step import TrainState as JaxTrainState
from dedloc_tpu.roles import swav as jax_role
from dedloc_tpu_torch.averaging.device_flat import DeviceFlatPipeline
from dedloc_tpu_torch.core.config import SwAVCollaborationArguments, parse_config
from dedloc_tpu_torch.parallel.train_step import TrainState, zeros_like_grads
from dedloc_tpu_torch.roles.swav import build_swav, run_swav
from dedloc_tpu_torch.utils.checkpoint import list_checkpoints


def _argv(out, max_steps=4, save_steps=2):
    return [
        "--dht.listen_host", "127.0.0.1",
        "--training.model_size", "tiny",
        "--training.per_device_batch_size", "2",
        "--training.gradient_accumulation_steps", "2",
        "--training.max_local_steps", str(max_steps),
        "--training.queue_length", "8",
        "--training.queue_start_step", "1",
        "--training.warmup_steps", "2",
        "--training.total_steps", "50",
        "--training.save_steps", str(save_steps),
        "--training.output_dir", str(out),
        # 2 boundaries of 2 x 2 samples per global step
        "--optimizer.target_batch_size", "8",
        "--averager.averaging_expiration", "1.0",
        # a lone peer takes the networked path (the flat apply) until its
        # progress record's lifetime has passed, then applies per leaf with
        # no round: keep the whole run inside that window
        "--averager.metadata_expiration", "300",
    ]


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the port's runs: after XLA's CPU runtime has
    run in the process (an earlier test file on this worker, or the JAX
    peer), torch's thread pool made one tiny-config backward take ~35 s
    instead of ~0.5 s in 2 of 3 runs on an 8-core box."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def logs(monkeypatch):
    """Messages of both packages' loggers; the port's roles on the CPU."""
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = _Capture(level=logging.INFO)
    loggers = [logging.getLogger(n) for n in ("dedloc_tpu", "dedloc_tpu_torch")]
    saved = [lg.level for lg in loggers]
    for lg in loggers:
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
    yield records
    for lg, level in zip(loggers, saved):
        lg.removeHandler(handler)
        lg.setLevel(level)


def test_run_swav_steps_engages_the_queue_and_resumes(tmp_path, logs, one_torch_thread):
    argv = _argv(tmp_path / "out")
    state = run_swav(parse_config(SwAVCollaborationArguments, argv))
    assert int(state.step) >= 1, "should have made at least one global step"
    assert list_checkpoints(str(tmp_path / "out"))
    assert any("queue engaged" in m for m in logs), logs
    applied = [m for m in logs if "(apply flat" in m]
    assert applied, logs
    assert not any("falling back" in m for m in logs)
    logs.clear()
    run_swav(parse_config(SwAVCollaborationArguments, argv))
    assert any("resumed from local checkpoint" in m for m in logs), logs[:10]
    steps = [int(m.split()[2].rstrip(":")) for m in logs if "(apply flat" in m]
    assert steps and steps[0] > 1, steps


def test_shared_state_and_wire_match_the_jax_peer():
    """Names, shapes and dtypes of the shared state ``(params, lars
    state)`` and of the gradient wire, and their fingerprints, equal the JAX
    SwAV peer's (so the two join one swarm and serve each other's state)."""
    argv = ["--training.model_size", "tiny"]
    _cfg, _spec, model, tx = build_swav(parse_config(SwAVCollaborationArguments, argv))
    state = TrainState.create(dict(model.named_parameters()), tx)
    ours = {k: np.asarray(v.contiguous().numpy()) for k, v in
            tx.state_views(state.params, state.opt_state).items()}
    jcfg, jspec, jmodel, jtx = jax_role.build_swav(jax_parse(JaxArgs, argv))
    crops = [jnp.zeros((c * 2, s, s, 3)) for s, c in zip(JaxSpec.tiny().sizes,
                                                        JaxSpec.tiny().counts)]
    shapes = jax.eval_shape(lambda: JaxTrainState.create(
        jmodel.init(jax.random.PRNGKey(0), crops, True)["params"], jtx))
    theirs = {jax.tree_util.keystr(path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path((shapes.params, shapes.opt_state))[0]}
    assert {k: (v.shape, v.dtype) for k, v in ours.items()} == {
        k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in theirs.items()}
    assert schema_fingerprint(ours) == schema_fingerprint(theirs)
    wire = DeviceFlatPipeline.for_tree(zeros_like_grads(state.params)).spec
    jwire = JaxPipeline.for_tree(shapes.params).spec
    assert [(n, tuple(s)) for n, s, _d in wire] == [(n, tuple(s)) for n, s, _d in jwire]
    assert spec_fingerprint(wire) == spec_fingerprint(jwire)
