"""The port's evaluator against the JAX package's: on a checkpoint written by
either package's trainer, the held-out MLM and SOP losses agree in an fp32
config; both checkpoint layouts load; two runs are identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedloc_tpu.core.config import CollaborationArguments as JaxArgs
from dedloc_tpu.core.config import parse_config as jax_parse_config
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.roles.evaluate import EvalArguments as JaxEvalArguments
from dedloc_tpu.roles.evaluate import run_eval as jax_run_eval
from dedloc_tpu.roles.trainer import run_trainer as jax_run_trainer
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.data.disk import write_shards
from dedloc_tpu_torch.models.albert import AlbertConfig
from dedloc_tpu_torch.roles.evaluate import EvalArguments, run_eval
from dedloc_tpu_torch.roles.trainer import run_trainer
from dedloc_tpu_torch.utils.checkpoint import load_latest_checkpoint, save_checkpoint

# tests/test_torch_albert.py's FP32 loss tolerance: one forward, the same
# weights and batch, reduction order only
LOSS_TOL = 1e-5
SEQ = 64


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Random-token instances in the shard layout (tests/test_roles.py)."""
    rng = np.random.default_rng(0)
    n = 48
    ids = rng.integers(5, 512, (n, SEQ)).astype(np.int32)
    ids[::3, 40:] = 0  # padded rows
    path = tmp_path_factory.mktemp("eval") / "shards"
    write_shards(str(path), iter([{
        "input_ids": ids,
        "token_type_ids": np.zeros((n, SEQ), np.int32),
        "special_tokens_mask": np.zeros((n, SEQ), np.int32),
        "sop_labels": rng.integers(0, 2, (n,)).astype(np.int32),
    }]))
    return str(path)


def _argv(shards, out, prefix):
    return [
        "--dht.experiment_prefix", prefix,
        "--dht.listen_host", "127.0.0.1",
        "--training.model_size", "tiny",
        "--training.seq_length", str(SEQ),
        "--training.per_device_batch_size", "4",
        "--training.gradient_accumulation_steps", "1",
        "--training.learning_rate", "1e-2",
        "--training.warmup_steps", "0",
        "--training.max_local_steps", "2",
        "--training.save_steps", "1",
        "--training.dataset_path", shards,
        "--training.output_dir", str(out),
        "--optimizer.target_batch_size", "4",
        "--averager.metadata_expiration", "0.2",
        "--averager.min_refresh_period", "0.1",
        "--averager.default_refresh_period", "0.2",
        "--checkpoint.cache_dir", "none",
    ]


@pytest.fixture(scope="module")
def checkpoints(shards, tmp_path_factory):
    """Output dirs holding a checkpoint of each package's trainer."""
    root = tmp_path_factory.mktemp("ckpt")
    jax_out, port_out = root / "jax", root / "torch"
    jax_run_trainer(jax_parse_config(JaxArgs, _argv(shards, jax_out, "eval-jax")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEDLOC_FORCE_CPU", "1")
        run_trainer(parse_config(CollaborationArguments,
                                 _argv(shards, port_out, "eval-torch")))
    for out in (jax_out, port_out):
        step, named, _meta = load_latest_checkpoint(str(out))
        assert step >= 1 and any(k.startswith("[1]") for k in named)
    return {"jax": jax_out, "torch": port_out}


@pytest.fixture
def fp32(monkeypatch):
    """Both packages' tiny config in fp32 (the roles build bf16 models)."""
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    for cls, dtype in ((JaxConfig, jnp.float32), (AlbertConfig, torch.float32)):
        tiny = cls.tiny
        monkeypatch.setattr(cls, "tiny", staticmethod(
            lambda tiny=tiny, dtype=dtype, **o: tiny(**{"dtype": dtype, **o})))


def _eval_both(shards, out, *flags):
    argv = _argv(shards, out, "eval") + list(flags)
    theirs = jax_run_eval(jax_parse_config(JaxArgs, argv),
                          JaxEvalArguments(max_batches=4))
    ours = run_eval(parse_config(CollaborationArguments, argv),
                    EvalArguments(max_batches=4))
    return ours, theirs


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_eval_matches_the_jax_evaluator(shards, checkpoints, fp32, writer):
    ours, theirs = _eval_both(shards, checkpoints[writer])
    assert sorted(ours) == sorted(theirs)
    assert ours["checkpoint_step"] == theirs["checkpoint_step"] >= 1
    assert ours["eval_batches"] == theirs["eval_batches"] == 4
    for key in ("mlm_loss", "sop_loss"):
        assert abs(ours[key] - theirs[key]) <= LOSS_TOL, (key, ours, theirs)
    np.testing.assert_allclose(ours["mlm_perplexity"],
                               theirs["mlm_perplexity"], rtol=LOSS_TOL)
    # a trained checkpoint, not a fresh init: near ln(512) but moved
    assert 4.0 < ours["mlm_loss"] < 8.0


def test_bare_params_load_as_the_trainers_pair(shards, checkpoints, fp32, tmp_path):
    step, named, _meta = load_latest_checkpoint(str(checkpoints["torch"]))
    bare = {k[3:]: v for k, v in named.items() if k.startswith("[0]")}
    save_checkpoint(str(tmp_path), step, bare, metadata={"local_step": step})
    argv = _argv(shards, checkpoints["torch"], "eval")
    args = parse_config(CollaborationArguments, argv)
    pair = run_eval(args, EvalArguments(max_batches=2))
    alone = run_eval(args, EvalArguments(
        max_batches=2, checkpoint_path=str(tmp_path / f"checkpoint-{step}")))
    assert alone == pair


def test_eval_repeats_exactly(shards, checkpoints, monkeypatch):
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    args = parse_config(CollaborationArguments,
                        _argv(shards, checkpoints["jax"], "eval"))
    first = run_eval(args, EvalArguments(max_batches=3))
    assert first == run_eval(args, EvalArguments(max_batches=3))
    assert np.isfinite(first["mlm_loss"]) and first["sop_loss"] > 0


def test_eval_without_cuda_raises_unless_the_cpu_is_asked_for(shards, tmp_path,
                                                             monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    monkeypatch.delenv("DEDLOC_FORCE_CPU", raising=False)
    args = parse_config(CollaborationArguments, _argv(shards, tmp_path, "eval"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_eval(args, EvalArguments(max_batches=1))
