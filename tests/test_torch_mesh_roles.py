"""The port's trainer CLI as a slice of CPU ranks (gloo, ``file://``
rendezvous, ``DEDLOC_FORCE_CPU=1``), mirroring the JAX package's
tests/test_roles.py slice tests: two slices as two peers of one
collaboration (a real group of 2, the slice's samples per boundary, the
two states bitwise equal at their last common step, the checkpoint
loading into the one-device model under its names and shapes), ZeRO-1,
ring attention, tensor parallelism with ZeRO, the pipeline and experts;
and the JAX trainer's refusals of mesh flags, plus a process group that
is not the slice's size."""
import hashlib
import json
import os
import re

import numpy as np
import pytest

from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.models import convert
from dedloc_tpu_torch.roles.common import build_dht, build_model
from dedloc_tpu_torch.roles.trainer import run_trainer
from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint
from torch_mesh_ranks import run_slice_cli, wait_slice


def _flags(out, *extra):
    return ["--dht.experiment_prefix", "torch-slice",
            "--dht.listen_host", "127.0.0.1",
            "--training.model_size", "tiny",
            "--training.per_device_batch_size", "2",
            "--training.seq_length", "32",
            "--training.gradient_accumulation_steps", "2",
            "--training.warmup_steps", "0",
            "--training.max_local_steps", "3",
            "--training.save_steps", "1",
            "--training.output_dir", str(out / "out"),
            "--training.train_log_path", str(out / "train.jsonl"),
            "--optimizer.target_batch_size", "8",
            "--averager.metadata_expiration", "0.2",
            "--averager.min_refresh_period", "0.1",
            "--averager.default_refresh_period", "0.2",
            "--checkpoint.cache_dir", "none", *extra]


def _records(out):
    with open(out / "train.jsonl") as f:
        return [json.loads(line) for line in f]


def _layout(logs):
    line = re.search(r"slice layout: .*", logs[0])
    return line.group(0) if line else ""


@pytest.mark.parametrize("flags,match", [
    (["--training.mesh_devices", "6", "--training.mesh_seq_devices", "4"],
     "must divide mesh_devices"),
    (["--training.mesh_devices", "8", "--training.mesh_pipe_devices", "2",
      "--training.mesh_model_devices", "2"], "data axis only"),
    (["--training.mesh_devices", "2", "--training.mesh_expert_devices", "2"],
     "needs --training.moe_experts"),
    (["--training.mesh_devices", "4", "--training.mesh_expert_devices", "2",
      "--training.moe_experts", "3"], "divide evenly over mesh_expert_devices"),
    (["--training.mesh_model_devices", "2"], "require mesh_devices > 1"),
    (["--training.mesh_devices", "2", "--training.attention_impl", "ring"],
     "sequence-parallel mesh axis"),
    (["--training.zero_sharding", "true"], "over a slice mesh"),
    # one process is not a slice of 2 ranks: the torchrun command is named
    (["--training.mesh_devices", "2"], "--nproc_per_node 2"),
])
def test_mesh_flags_are_refused_with_the_jax_reasons(tmp_path, monkeypatch, flags,
                                                     match):
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = parse_config(CollaborationArguments, _flags(tmp_path, *flags))
    with pytest.raises(ValueError, match=re.escape(match)):
        run_trainer(args)


def _state_hash(out, step):
    tree = load_latest_checkpoint(str(out / "out"))
    assert tree is not None
    from dedloc_tpu_torch.utils.checkpoint import load_checkpoint

    named = load_checkpoint(os.path.join(str(out / "out"), f"checkpoint-{step}"))[1]
    h = hashlib.sha256()
    for k in sorted(named):
        h.update(k.encode())
        h.update(np.ascontiguousarray(named[k]).tobytes())
    return h.hexdigest()


def test_two_slice_peers(tmp_path):
    """Two dp1 x tp2 slices (2 ranks each) as two peers of one
    collaboration: each boundary contributes 2 (per device) x 2 (mesh) x 2
    (accumulation) = 8 samples, the two reach the target of 16 together
    and average in groups of 2."""
    root_args = parse_config(CollaborationArguments, _flags(tmp_path))
    root, _ = build_dht(root_args)
    try:
        addr = root.get_visible_address()
        mesh = ["--training.mesh_devices", "2", "--training.mesh_model_devices", "2",
                "--dht.initial_peers", addr, "--optimizer.target_batch_size", "16",
                "--training.max_local_steps", "6",
                "--averager.averaging_expiration", "15"]
        for i in (0, 1):
            (tmp_path / f"s{i}").mkdir()
        running = [run_slice_cli(str(tmp_path), 2,
                                 _flags(tmp_path / f"s{i}", *mesh),
                                 timeout=150, name=f"s{i}", wait=False)
                   for i in (0, 1)]
        logs = [wait_slice(r) for r in running]
    finally:
        root.shutdown()
    steps = []
    for i in (0, 1):
        records = _records(tmp_path / f"s{i}")
        assert records and all(r["samples"] == 8 for r in records)
        assert any(r["group_size"] == 2 for r in records), records
        assert "group=2" in logs[i][0]
        steps.append({r["step"] for r in records})
    common = max(steps[0] & steps[1])
    assert _state_hash(tmp_path / "s0", common) == _state_hash(tmp_path / "s1", common)
    # the checkpoint is a one-device peer's: its names and shapes load
    # into the one-device port model
    _step, named, _meta = load_latest_checkpoint(str(tmp_path / "s0" / "out"))
    _cfg, model = build_model("tiny", device="cpu")
    params = convert.params_from_checkpoint(named)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(params)


def test_trainer_zero_sharding_on_mesh(tmp_path):
    logs = run_slice_cli(str(tmp_path), 2, _flags(
        tmp_path, "--training.mesh_devices", "2", "--training.zero_sharding", "true"))
    assert max(r["step"] for r in _records(tmp_path)) >= 1
    assert "moment leaves over ['data']" in _layout(logs)
    assert re.search(r"0 parameter leaves split", _layout(logs))


def test_trainer_ring_attention_sequence_parallel(tmp_path):
    run_slice_cli(str(tmp_path), 4, _flags(
        tmp_path, "--training.mesh_devices", "4", "--training.mesh_seq_devices", "2",
        "--training.attention_impl", "ring"))
    records = _records(tmp_path)
    assert max(r["step"] for r in records) >= 1
    assert all(np.isfinite(r["loss"]) for r in records)


def test_trainer_tensor_parallel_on_mesh(tmp_path):
    logs = run_slice_cli(str(tmp_path), 4, _flags(
        tmp_path, "--training.mesh_devices", "4", "--training.mesh_model_devices", "2",
        "--training.zero_sharding", "true"))
    assert max(r["step"] for r in _records(tmp_path)) >= 1
    layout = _layout(logs)
    assert "parameter leaves split over ['model']" in layout
    assert "moment leaves over ['data', 'model']" in layout


def test_trainer_pipeline_parallel_on_mesh(tmp_path):
    run_slice_cli(str(tmp_path), 4, _flags(
        tmp_path, "--training.mesh_devices", "4", "--training.mesh_pipe_devices", "2",
        "--training.pipe_microbatches", "4"))
    assert max(r["step"] for r in _records(tmp_path)) >= 1
    # the checkpoint carries the scanned model's leaf names
    _step, named, _meta = load_latest_checkpoint(str(tmp_path / "out"))
    assert any("['encoder']['layer']['block']" in k for k in named)


def test_trainer_moe_expert_parallel_on_mesh(tmp_path):
    logs = run_slice_cli(str(tmp_path), 4, _flags(
        tmp_path, "--training.mesh_devices", "4", "--training.mesh_expert_devices", "2",
        "--training.moe_experts", "4", "--training.zero_sharding", "true"))
    records = _records(tmp_path)
    assert max(r["step"] for r in records) >= 1
    layout = _layout(logs)
    assert "parameter leaves split over ['expert']" in layout
    assert "moment leaves over ['data', 'expert']" in layout
    _step, named, _meta = load_latest_checkpoint(str(tmp_path / "out"))
    wi = [v for k, v in named.items() if k.startswith("[0]") and "moe_wi" in k]
    assert wi and wi[0].shape[0] == 4  # the full expert stack
