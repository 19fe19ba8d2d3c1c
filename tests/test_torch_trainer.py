"""The port's trainer role and join entry point: a solo peer on the CPU
when the caller asks for it, a refusal without CUDA otherwise, the same
join flags as the JAX package, and the slice options refused outside a
slice."""
import json

import numpy as np
import pytest
import torch

from dedloc_tpu.join import build_trainer_argv as jax_build_trainer_argv
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.join import build_trainer_argv
from dedloc_tpu_torch.roles.trainer import run_trainer
from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint


def _args(tmp_path, *extra):
    return parse_config(CollaborationArguments, [
        "--dht.experiment_prefix", "torch-trainer",
        "--dht.listen_host", "127.0.0.1",
        "--training.model_size", "tiny",
        "--training.per_device_batch_size", "2",
        "--training.seq_length", "32",
        "--training.gradient_accumulation_steps", "2",
        "--training.warmup_steps", "0",
        "--training.max_local_steps", "2",
        "--training.save_steps", "1",
        "--training.output_dir", str(tmp_path / "out"),
        "--training.train_log_path", str(tmp_path / "train.jsonl"),
        "--optimizer.target_batch_size", "4",
        "--averager.metadata_expiration", "0.2",
        "--averager.min_refresh_period", "0.1",
        "--averager.default_refresh_period", "0.2",
        "--checkpoint.cache_dir", "none",
        *extra,
    ])


def test_solo_trainer_on_the_cpu_takes_its_boundaries(tmp_path, monkeypatch):
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    state = run_trainer(_args(tmp_path))
    p = next(iter(state.params.values()))
    assert p.device.type == "cpu"
    assert all(torch.isfinite(v).all() for v in state.params.values())
    records = [json.loads(line) for line in
               (tmp_path / "train.jsonl").read_text().splitlines()]
    assert records, "no global step in two boundaries"
    for r in records:
        assert np.isfinite(r["loss"])
        assert r["group_size"] == 1 and r["apply"] == "leaf"
    # the checkpoint carries the JAX trainer's shared-state names
    step, named, meta = load_latest_checkpoint(str(tmp_path / "out"))
    assert step == records[-1]["step"] == meta["local_step"]
    assert "[1][1].count" in named and "[1][2].count" in named
    assert any(k.startswith("[0]['albert']") for k in named)


def test_trainer_resumes_from_its_checkpoint(tmp_path, monkeypatch):
    """A second run in the same output dir starts from the newest
    checkpoint: with no global step of its own, it ends on that state."""
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    first = run_trainer(_args(tmp_path))
    saved = {k: v.detach().clone() for k, v in first.params.items()}
    _step, _named, meta = load_latest_checkpoint(str(tmp_path / "out"))
    resumed = run_trainer(_args(tmp_path, "--training.max_local_steps", "1",
                                "--optimizer.target_batch_size", "1000000"))
    assert int(resumed.step) == meta["step"] == int(first.step)
    for name, ref in saved.items():
        assert torch.equal(resumed.params[name].detach(), ref), name


def test_trainer_without_cuda_raises_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    monkeypatch.delenv("DEDLOC_FORCE_CPU", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_trainer(_args(tmp_path))


@pytest.mark.parametrize("flags,match", [
    # a slice needs its ranks: one process is told the torchrun command
    (["--training.mesh_devices", "2"], "torch.distributed.run"),
    (["--training.zero_sharding", "true"], "mesh_devices > 1"),
    (["--training.moe_experts", "2", "--training.mesh_expert_devices", "2"],
     "require mesh_devices > 1"),
    (["--training.attention_impl", "ring"], "sequence-parallel mesh axis"),
], ids=[f"flags{i}-one device" for i in range(4)])
def test_options_of_later_slices_are_refused(tmp_path, monkeypatch, flags, match):
    """Slice options without a slice (or without its ranks) are refused
    with the JAX trainer's reasons, before any network or device setup."""
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    with pytest.raises(ValueError, match=match):
        run_trainer(_args(tmp_path, *flags))


@pytest.mark.parametrize("argv", [
    ["--initial_peers", "10.0.0.1:31337,10.0.0.2:31337",
     "--experiment_prefix", "run"],
    ["--initial_peers", "h:1", "--experiment_prefix", "run", "--username",
     "alice", "--credential", "pw", "--client_mode", "--relay", "r:2",
     "--batch_size", "8", "--training.seq_length", "128"],
])
def test_join_maps_the_same_flags_as_the_jax_package(argv):
    ours = build_trainer_argv(argv)
    assert ours == jax_build_trainer_argv(argv)
    args = parse_config(CollaborationArguments, ours)
    assert args.dht.experiment_prefix == "run"
