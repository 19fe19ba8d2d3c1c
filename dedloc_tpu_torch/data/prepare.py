"""Corpus preparation CLI: text -> tokenized MLM+SOP instance shards.

Capability parity with the reference's standalone data-prep script
(albert/tokenize_wikitext103.py): sentence-split raw documents, tokenize,
pack into segment-pair MLM+SOP instances (random A/B swap for the
sentence-order label), and cache to disk for the trainer role's
``--training.dataset_path``.

Run:
    python -m dedloc_tpu_torch.data.prepare \\
        --input corpus1.txt corpus2.txt \\
        --tokenizer_path tokenizer.json \\
        --output_dir data/tokenized \\
        --max_seq_length 512

Input files are one DOCUMENT per line (the streaming pipeline's layout);
blank lines are skipped. Masking is NOT applied here — it happens on the
fly at train time so every epoch sees fresh masks (mask_tokens in
data/disk.py), matching the reference's collator-side masking.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

import numpy as np

from dedloc_tpu_torch.core.config import parse_config
from dedloc_tpu_torch.data.mlm import (
    SpecialTokens,
    create_instances_from_document,
    pad_and_batch,
)
from dedloc_tpu_torch.data.streaming import split_sentences
from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class PrepareArguments:
    input: List[str] = field(default_factory=list)  # one document per line
    tokenizer_path: str = ""  # trained tokenizer.json
    output_dir: str = "data/tokenized"
    max_seq_length: int = 512
    examples_per_shard: int = 8192
    batch_size: int = 256  # instance-packing granularity
    seed: int = 0


def instance_batches(
    documents: Iterator[str],
    tokenize_sentences,
    tokens: SpecialTokens,
    max_seq_length: int,
    batch_size: int,
    seed: int,
) -> Iterator[Dict[str, np.ndarray]]:
    """Documents -> padded instance batches ready for ``write_shards``."""
    rng = np.random.default_rng(seed)
    pending: List[Dict[str, np.ndarray]] = []
    for doc in documents:
        sentences = tokenize_sentences(doc)
        pending.extend(
            create_instances_from_document(
                sentences, max_seq_length, rng, tokens
            )
        )
        while len(pending) >= batch_size:
            group, pending = pending[:batch_size], pending[batch_size:]
            yield pad_and_batch(group, max_seq_length, tokens)
    if pending:
        yield pad_and_batch(pending, max_seq_length, tokens)


def run_prepare(args: PrepareArguments) -> int:
    from dedloc_tpu_torch.data.disk import write_shards
    from dedloc_tpu_torch.data.tokenizer import load_fast_tokenizer

    if not args.input:
        raise ValueError("--input: at least one document file is required")
    tok = load_fast_tokenizer(args.tokenizer_path)
    tokens = SpecialTokens(
        cls_id=tok.cls_id, sep_id=tok.sep_id, pad_id=tok.pad_id,
        mask_id=tok.mask_id, vocab_size=tok.vocab_size,
    )

    def documents() -> Iterator[str]:
        for path in args.input:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield line

    def tokenize_sentences(doc: str) -> List[List[int]]:
        return [
            tok.encode_ids(s, add_special_tokens=False)
            for s in split_sentences(doc)
        ]

    total = write_shards(
        args.output_dir,
        instance_batches(
            documents(), tokenize_sentences, tokens,
            args.max_seq_length, args.batch_size, args.seed,
        ),
        examples_per_shard=args.examples_per_shard,
    )
    # dataset metadata: lets the trainer fail fast when the model's vocab is
    # smaller than the tokenizer's (out-of-range embedding lookups otherwise
    # surface as NaN params a full global step later)
    import json
    import os

    with open(os.path.join(args.output_dir, "meta.json"), "w") as f:
        json.dump(
            {
                "vocab_size": tok.vocab_size,
                "max_seq_length": args.max_seq_length,
                "num_instances": total,
                "tokenizer_path": args.tokenizer_path,
            },
            f,
        )
    logger.info(
        f"wrote {total} instances to {args.output_dir} "
        f"(max_seq_length={args.max_seq_length})"
    )
    return total


def main(argv=None) -> None:
    run_prepare(parse_config(PrepareArguments, argv))


if __name__ == "__main__":
    main()
