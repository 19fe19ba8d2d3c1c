"""``dedloc_tpu_torch/tools/word_corpus.py``: word-level MLM+SOP shards
with no tokenizers package. The shards are the same bytes for the same
documents and seed; the unigram entropy it writes equals a direct count of
the train shards' maskable ids; the shards feed the trainer's disk loader."""
import collections
import json
import math
import os
import sysconfig

import numpy as np
import pytest

from dedloc_tpu_torch.core.serialization import deserialize_tree
from dedloc_tpu_torch.data.corpus import harvest
from dedloc_tpu_torch.data.disk import tokenized_dataset_batches
from dedloc_tpu_torch.models.albert import AlbertConfig
from dedloc_tpu_torch.tools import word_corpus as wc

SEQ, VOCAB = 32, 512


@pytest.fixture(scope="module")
def docs():
    return list(harvest([os.path.join(sysconfig.get_paths()["stdlib"], "json")]
                        + [os.path.join(sysconfig.get_paths()["stdlib"], "email")],
                        max_docs=120))


def _shard_bytes(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_shards_are_deterministic_for_a_seed(docs, tmp_path):
    for run in ("a", "b"):
        wc.write_word_shards(docs, str(tmp_path / run), SEQ, VOCAB, seed=3)
    for split in ("train", "holdout"):
        a = _shard_bytes(tmp_path / "a" / split)
        assert a and a == _shard_bytes(tmp_path / "b" / split)
    wc.write_word_shards(docs, str(tmp_path / "c"), SEQ, VOCAB, seed=4)
    assert _shard_bytes(tmp_path / "c" / "train") != _shard_bytes(tmp_path / "a" / "train")


def test_every_tenth_document_is_held_out(docs, tmp_path):
    report, vocab = wc.write_word_shards(docs, str(tmp_path), SEQ, VOCAB)
    assert report["holdout"]["documents"] == len(docs[::10])
    assert report["train"]["documents"] == len(docs) - len(docs[::10])
    assert report["vocab_ids"] == VOCAB  # these documents have more words
    assert vocab.encode("the") == [vocab.ids["the"]] and vocab.ids["the"] >= 5
    with open(tmp_path / "train" / "meta.json") as f:
        meta = json.load(f)
    assert meta == {"vocab_size": VOCAB, "max_seq_length": SEQ,
                    "num_instances": report["train"]["instances"]}


def test_unigram_entropy_equals_a_direct_count(docs, tmp_path):
    wc.write_word_shards(docs, str(tmp_path), SEQ, VOCAB)
    got = wc.unigram_entropy(wc.target_counts(str(tmp_path / "train"), VOCAB))
    counts = collections.Counter()
    for name in os.listdir(tmp_path / "train"):
        if not name.endswith(".bin"):
            continue
        with open(tmp_path / "train" / name, "rb") as f:
            cols = deserialize_tree(f.read())
        for row, special in zip(cols["input_ids"], cols["special_tokens_mask"]):
            for token, s in zip(row, special):
                if s == 0 and token != 0:
                    counts[int(token)] += 1
    total = sum(counts.values())
    want = -sum(c / total * math.log(c / total) for c in counts.values())
    assert got == pytest.approx(want, rel=1e-12)
    assert 0 < got < math.log(VOCAB)


def test_build_writes_the_entropy_and_the_trainer_reads_the_shards(tmp_path):
    report = wc.build(str(tmp_path), SEQ, VOCAB, seed=0,
                      roots=[os.path.join(sysconfig.get_paths()["stdlib"], "json")])
    with open(tmp_path / "corpus.json") as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert report["unigram_entropy_nats"] > 0 and report["train_targets"] > 0
    batch = next(tokenized_dataset_batches(report["train"]["path"],
                                           AlbertConfig.tiny(), 4, SEQ, seed=0))
    assert batch["input_ids"].shape == (4, SEQ)
    assert batch["mlm_positions"].shape[0] == 4
    assert int(np.max(batch["input_ids"])) < VOCAB


def test_cli_prints_the_report(tmp_path, capsys):
    wc.main(["--out", str(tmp_path), "--seq_length", str(SEQ), "--vocab_size",
             str(VOCAB), "--roots", os.path.join(sysconfig.get_paths()["stdlib"], "json")])
    report = json.loads(capsys.readouterr().out)
    assert report["seq_length"] == SEQ and "unigram_entropy_nats" in report
