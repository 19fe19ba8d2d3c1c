"""Word-level MLM+SOP shards with no ``tokenizers`` package.

The JAX package's runs trained a BPE tokenizer on a harvested corpus
(docs/real-data.md); a machine without the ``tokenizers`` package still
has the documents. This tool runs the same chain with a word-level
vocabulary in place of the tokenizer:

    docstrings and docs (``data/corpus.py`` ``harvest``)
      -> word ids (``WordVocab``: the 5 special tokens of ``data/mlm.py``,
         then the most frequent lower-cased words)
      -> S-length MLM+SOP instances (``data/prepare.py`` ``instance_batches``)
      -> shards (``data/disk.py`` ``write_shards``), every tenth document
         held out.

It also writes the unigram entropy (nats) of the masked targets of the
train shards: every position that ``data/mlm.py`` ``mask_tokens`` may
label (not special, not padding) is a target with the same probability,
so the targets' distribution is the ids' distribution over those
positions. Its entropy is the loss of a model that ignores context, the
mark a run that learns from context must fall below.

    python -m dedloc_tpu_torch.tools.word_corpus --out /path/corpus \
        --seq_length 128 --vocab_size 30000 [--roots DIR ...] [--max_docs N]

writes ``<out>/train``, ``<out>/holdout`` (each with ``meta.json``, the
trainer's ``--training.dataset_path``) and ``<out>/corpus.json``.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sysconfig
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np

from dedloc_tpu_torch.core.serialization import deserialize_tree
from dedloc_tpu_torch.data.corpus import harvest
from dedloc_tpu_torch.data.disk import write_shards
from dedloc_tpu_torch.data.mlm import SpecialTokens
from dedloc_tpu_torch.data.prepare import instance_batches
from dedloc_tpu_torch.data.streaming import split_sentences

WORDS = re.compile(r"\w+|[^\w\s]")  # a word or one punctuation mark
HOLDOUT_EVERY = 10


class WordVocab:
    """Word-level ids: the 5 special tokens of ``data/mlm.py``
    ``SpecialTokens`` (pad, unk, [CLS], [SEP], [MASK]), then the most
    frequent lower-cased words, within ``size`` ids; other words are unk
    (1)."""

    def __init__(self, docs, size: int):
        counts = collections.Counter(
            w for d in docs for w in WORDS.findall(d.lower()))
        self.words = [w for w, _ in counts.most_common(size - 5)]
        self.ids = {w: 5 + i for i, w in enumerate(self.words)}

    def encode(self, text: str) -> list:
        return [self.ids.get(w, 1) for w in WORDS.findall(text.lower())]


def stdlib_documents() -> List[str]:
    """The standard library's docstrings and docs: the corpus every
    Python installation has."""
    return list(harvest([sysconfig.get_paths()["stdlib"]]))


def write_word_shards(docs: List[str], out: str, seq_length: int,
                      vocab_size: int = 30000, seed: int = 0,
                      examples_per_shard: int = 1024) -> Tuple[dict, WordVocab]:
    """``docs`` under a word vocabulary of ``vocab_size`` ids -> MLM+SOP
    shards of ``seq_length`` under ``<out>/train`` and ``<out>/holdout``
    (every tenth document), each with its ``meta.json``. Returns the
    counts and paths, and the vocabulary."""
    tokens = SpecialTokens(vocab_size=vocab_size)
    vocab = WordVocab(docs, vocab_size)
    splits = {"train": [d for i, d in enumerate(docs) if i % HOLDOUT_EVERY],
              "holdout": docs[::HOLDOUT_EVERY]}
    report = dict(documents=len(docs), vocab_ids=5 + len(vocab.words),
                  vocab_size=vocab_size, seq_length=seq_length, seed=seed)
    for name, split in splits.items():
        path = os.path.join(out, name)
        n_tokens = [0]

        def counted(batches):
            for b in batches:
                n_tokens[0] += int((b["input_ids"] != tokens.pad_id).sum())
                yield b

        total = write_shards(path, counted(instance_batches(
            iter(split),
            lambda doc: [vocab.encode(x) for x in split_sentences(doc)],
            tokens, seq_length, 256, seed)), examples_per_shard=examples_per_shard)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"vocab_size": vocab_size, "max_seq_length": seq_length,
                       "num_instances": total}, f)
        report[name] = dict(path=path, documents=len(split), instances=total,
                            tokens=n_tokens[0])
    return report, vocab


def target_counts(path: str, vocab_size: int) -> np.ndarray:
    """How often each id stands at a position ``mask_tokens`` may label
    (not special, not padding), over every shard under ``path``."""
    counts = np.zeros(vocab_size, np.int64)
    for name in sorted(os.listdir(path)):
        if not name.endswith(".bin"):
            continue
        with open(os.path.join(path, name), "rb") as f:
            cols = deserialize_tree(f.read())  # written by write_shards
        ids = np.asarray(cols["input_ids"])
        maskable = (np.asarray(cols["special_tokens_mask"]) == 0) & (ids != 0)
        counts += np.bincount(ids[maskable], minlength=vocab_size)
    return counts


def unigram_entropy(counts: np.ndarray) -> float:
    """The entropy (nats) of the distribution ``counts`` gives."""
    p = counts[counts > 0] / counts.sum()
    return float(-(p * np.log(p)).sum())


def build(out: str, seq_length: int, vocab_size: int = 30000, seed: int = 0,
          roots: Optional[Iterable[str]] = None, max_docs: int = 0) -> dict:
    """The whole chain: harvest ``roots`` (the standard library when
    none are named), write the shards, and ``<out>/corpus.json`` with the
    counts and the train targets' unigram entropy."""
    t0 = time.perf_counter()
    if roots:
        docs = list(harvest(list(roots), max_docs=max_docs))
    else:
        docs = stdlib_documents()
        if max_docs:
            docs = docs[:max_docs]
    harvest_s = time.perf_counter() - t0
    report, _vocab = write_word_shards(docs, out, seq_length, vocab_size, seed)
    counts = target_counts(report["train"]["path"], vocab_size)
    report.update(harvest_s=harvest_s,
                  build_s=time.perf_counter() - t0,
                  train_targets=int(counts.sum()),
                  unk_share=float(counts[1] / max(counts.sum(), 1)),
                  unigram_entropy_nats=unigram_entropy(counts))
    with open(os.path.join(out, "corpus.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--seq_length", type=int, default=128)
    p.add_argument("--vocab_size", type=int, default=30000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--roots", nargs="*", default=None,
                   help="directories to harvest (default: the standard library)")
    p.add_argument("--max_docs", type=int, default=0)
    args = p.parse_args(argv)
    report = build(args.out, args.seq_length, args.vocab_size, args.seed,
                   args.roots, args.max_docs)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
