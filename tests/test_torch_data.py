"""The port's data slice: the copied corpus, tokenizer, prepare and shard
modules run, make the same shards as the JAX package's, and feed the port's
trainer the JAX trainer's batches (on-disk shards and the streaming mix),
through to a trainer that steps on them on the CPU."""
import json
import os

import numpy as np
import pytest

from dedloc_tpu.core.config import CollaborationArguments as JaxArgs
from dedloc_tpu.core.config import parse_config as jax_parse_config
from dedloc_tpu.data.prepare import PrepareArguments as JaxPrepareArguments
from dedloc_tpu.data.prepare import run_prepare as jax_run_prepare
from dedloc_tpu.models.albert import AlbertConfig as JaxConfig
from dedloc_tpu.roles.trainer import _make_batches as jax_make_batches
from dedloc_tpu_torch.core.config import CollaborationArguments, parse_config
from dedloc_tpu_torch.data.corpus import CorpusArguments, harvest, run_corpus
from dedloc_tpu_torch.data.disk import tokenized_dataset_batches, write_shards
from dedloc_tpu_torch.data.prepare import (
    PrepareArguments,
    instance_batches,
    run_prepare,
)
from dedloc_tpu_torch.data.tokenizer import (
    FastTokenizer,
    load_fast_tokenizer,
    train_unigram_tokenizer,
)
from dedloc_tpu_torch.models.albert import AlbertConfig
from dedloc_tpu_torch.roles.trainer import _make_batches, run_trainer

SEQ = 64
PEER_KEY = b"torch-data-peer-key"
_DOC = ('"""{0} is a short module about the {1} of things. It explains how '
        'the {1} is kept and why it matters to every reader of the code. The '
        'notes go on for a while so that the text reads as prose and not as '
        'a table of symbols. Each sentence ends with a full stop, and the '
        'last one ends here."""\n')


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Docstring prose harvested by the copied corpus module, a unigram
    tokenizer trained on it, and its shards written by the copied prepare
    module (the chain of tests/test_data.py)."""
    root = tmp_path_factory.mktemp("data")
    src = root / "src"
    src.mkdir()
    rng = np.random.default_rng(0)
    topics = [f"topic{i}" for i in range(30)]
    for i in range(40):
        words = rng.choice(topics, 2)
        (src / f"mod{i}.py").write_text(_DOC.format(*words))
    text = root / "corpus.txt"
    n_docs = run_corpus(CorpusArguments(output=str(text), roots=[str(src)],
                                        min_words=20))
    docs = text.read_text().splitlines()
    tok_path = root / "tokenizer.json"
    train_unigram_tokenizer(docs, vocab_size=300).save(str(tok_path))
    shards = root / "shards"
    total = run_prepare(PrepareArguments(
        input=[str(text)], tokenizer_path=str(tok_path),
        output_dir=str(shards), max_seq_length=SEQ, batch_size=8,
        examples_per_shard=16))
    return dict(root=root, text=text, n_docs=n_docs, docs=docs,
                tok_path=str(tok_path), shards=str(shards), total=total)


def test_copies_harvest_tokenize_and_prepare(corpus):
    assert corpus["n_docs"] == len(corpus["docs"]) >= 20
    assert list(harvest([str(corpus["root"] / "src")], min_words=20))
    tok = load_fast_tokenizer(corpus["tok_path"])
    assert isinstance(tok, FastTokenizer) and tok.vocab_size <= 300
    ids = tok.encode_ids(corpus["docs"][0])
    assert ids[0] == tok.cls_id and ids[-1] == tok.sep_id
    assert corpus["total"] > 0
    shards = sorted(f for f in os.listdir(corpus["shards"]) if f.endswith(".bin"))
    assert len(shards) >= 2
    with open(os.path.join(corpus["shards"], "meta.json")) as f:
        meta = json.load(f)
    assert meta["num_instances"] == corpus["total"]
    assert meta["vocab_size"] == tok.vocab_size


def test_shards_are_the_jax_packages_byte_for_byte(corpus, tmp_path):
    out = tmp_path / "jax_shards"
    total = jax_run_prepare(JaxPrepareArguments(
        input=[str(corpus["text"])], tokenizer_path=corpus["tok_path"],
        output_dir=str(out), max_seq_length=SEQ, batch_size=8,
        examples_per_shard=16))
    assert total == corpus["total"]
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(corpus["shards"]))
    for name in names:
        assert (out / name).read_bytes() == \
            open(os.path.join(corpus["shards"], name), "rb").read(), name


def test_write_shards_round_trips_instance_batches(tmp_path):
    from dedloc_tpu_torch.data.mlm import SpecialTokens

    tokens = SpecialTokens(vocab_size=64)
    docs = [" ".join(f"w{i % 7}" for i in range(j, j + 40)) + ". end." for j in range(6)]
    batches = instance_batches(
        iter(docs), lambda d: [[5 + len(w) for w in s.split()] for s in d.split(". ")],
        tokens, 32, 4, seed=0)
    total = write_shards(str(tmp_path), batches, examples_per_shard=4)
    assert total > 0

    class Cfg:
        vocab_size = 64
        max_position_embeddings = 32

    batch = next(tokenized_dataset_batches(str(tmp_path), Cfg, 2, 32, seed=0))
    assert batch["input_ids"].shape == (2, 32)


def _both_args(flags):
    argv = ["--training.model_size", "tiny", "--training.seq_length", str(SEQ),
            "--training.per_device_batch_size", "4", *flags]
    return jax_parse_config(JaxArgs, argv), parse_config(CollaborationArguments, argv)


@pytest.mark.parametrize("source", ["dataset_path", "streaming_files"])
def test_trainer_batches_equal_the_jax_trainers(corpus, source):
    if source == "dataset_path":
        flags = ["--training.dataset_path", corpus["shards"]]
    else:
        flags = ["--training.streaming_files", str(corpus["text"]),
                 "--training.tokenizer_path", corpus["tok_path"],
                 "--training.streaming_buffer_size", "16"]
    jargs, args = _both_args(flags)
    theirs = jax_make_batches(jargs, JaxConfig.tiny(), PEER_KEY)
    ours = _make_batches(args, AlbertConfig.tiny(), PEER_KEY)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        assert a["input_ids"].shape == (4, SEQ)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_streaming_refuses_a_tokenizer_larger_than_the_model(corpus):
    _, args = _both_args(["--training.streaming_files", str(corpus["text"]),
                          "--training.tokenizer_path", corpus["tok_path"]])
    with pytest.raises(ValueError, match="exceeds the model's vocab_size"):
        _make_batches(args, AlbertConfig.tiny(vocab_size=64), PEER_KEY)


@pytest.mark.parametrize("source", ["dataset_path", "streaming_files"])
def test_port_trainer_steps_on_real_text(corpus, tmp_path, monkeypatch, source):
    monkeypatch.setenv("DEDLOC_FORCE_CPU", "1")
    if source == "dataset_path":
        flags = ["--training.dataset_path", corpus["shards"]]
    else:
        flags = ["--training.streaming_files", str(corpus["text"]),
                 "--training.tokenizer_path", corpus["tok_path"]]
    log = tmp_path / "train.jsonl"
    state = run_trainer(parse_config(CollaborationArguments, [
        "--dht.experiment_prefix", f"torch-data-{source}",
        "--dht.listen_host", "127.0.0.1",
        "--training.model_size", "tiny",
        "--training.seq_length", str(SEQ),
        "--training.per_device_batch_size", "4",
        "--training.gradient_accumulation_steps", "1",
        "--training.warmup_steps", "0",
        "--training.max_local_steps", "2",
        "--training.output_dir", str(tmp_path / "out"),
        "--training.train_log_path", str(log),
        "--optimizer.target_batch_size", "4",
        "--averager.metadata_expiration", "0.2",
        "--averager.min_refresh_period", "0.1",
        "--averager.default_refresh_period", "0.2",
        "--checkpoint.cache_dir", "none",
        *flags,
    ]))
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert records and int(state.step) >= 1
    # ln(512) + ln(2) at init on the tiny config's vocab
    assert all(np.isfinite(r["loss"]) and 5.0 < r["loss"] < 9.0 for r in records)
