"""On-disk tokenized dataset reader for the trainer role.

The reference tokenizes WikiText-103 once and caches it with
``datasets.save_to_disk`` (albert/tokenize_wikitext103.py:90-104); trainers
then memory-map it. Here the cached layout is the framework's own wire
format: a directory of ``shard-*.bin`` files, each a serialized tree of
column arrays (see ``write_shards``) — mmap-friendly, tokenizer-agnostic,
and with no dependency on the `datasets` wheel at train time.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np

from dedloc_tpu_torch.core.serialization import (
    CompressionType,
    deserialize_tree,
    serialize_tree,
)
from dedloc_tpu_torch.data.mlm import SpecialTokens, mask_tokens, max_predictions_for

COLUMNS = ("input_ids", "token_type_ids", "special_tokens_mask", "sop_labels")


def write_shards(
    path: str,
    batches: Iterator[Dict[str, np.ndarray]],
    examples_per_shard: int = 8192,
) -> int:
    """Write batched instances into shard files; returns total examples."""
    os.makedirs(path, exist_ok=True)
    buf: List[Dict[str, np.ndarray]] = []
    count = n_shards = 0

    def flush() -> None:
        nonlocal buf, n_shards
        if not buf:
            return
        merged = {
            k: np.concatenate([b[k] for b in buf], axis=0) for k in COLUMNS
        }
        blob = serialize_tree(merged, CompressionType.NONE)
        with open(os.path.join(path, f"shard-{n_shards:05d}.bin"), "wb") as f:
            f.write(blob)
        n_shards += 1
        buf = []

    pending = 0
    for batch in batches:
        buf.append({k: np.asarray(batch[k]) for k in COLUMNS})
        pending += len(batch["input_ids"])
        count += len(batch["input_ids"])
        if pending >= examples_per_shard:
            flush()
            pending = 0
    flush()
    return count


def tokenized_dataset_batches(
    path: str,
    cfg,
    batch_size: int,
    seq_length: int,
    seed: int,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite shuffled batch stream over the cached shards, with fresh MLM
    masking each epoch (per-peer seed ⇒ independent shuffling,
    run_trainer.py:266-270 capability)."""
    shards = sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(".bin")
    )
    if not shards:
        raise FileNotFoundError(f"no shard-*.bin files under {path}")
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        import json

        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("vocab_size", 0) > cfg.vocab_size:
            raise ValueError(
                f"dataset at {path} was tokenized with vocab "
                f"{meta['vocab_size']} but the model's vocab_size is only "
                f"{cfg.vocab_size}; out-of-range ids would corrupt the "
                f"embedding lookup. Use --training.vocab_size "
                f"{meta['vocab_size']} or retokenize."
            )
    rng = np.random.default_rng(seed)
    tokens = SpecialTokens(vocab_size=cfg.vocab_size)
    seq_length = min(seq_length, cfg.max_position_embeddings)
    # gathered label layout: the model projects to the vocab only at masked
    # positions (~15%), not all seq_length of them — on ALBERT-large this is
    # the difference between a 512x30k and an 81x30k logits tensor per row
    max_predictions = max_predictions_for(seq_length)
    while True:
        for shard_path in rng.permutation(shards):
            with open(shard_path, "rb") as f:
                cols = deserialize_tree(f.read())
            n = len(cols["input_ids"])
            order = rng.permutation(n)
            for start in range(0, n - batch_size + 1, batch_size):
                idx = order[start : start + batch_size]
                ids = cols["input_ids"][idx, :seq_length].astype(np.int32)
                batch = {
                    "input_ids": ids,
                    "token_type_ids": cols["token_type_ids"][idx, :seq_length].astype(
                        np.int32
                    ),
                    "special_tokens_mask": cols["special_tokens_mask"][
                        idx, :seq_length
                    ].astype(np.int32),
                    "attention_mask": (ids != tokens.pad_id).astype(np.int32),
                    "sop_labels": cols["sop_labels"][idx].astype(np.int32),
                }
                yield mask_tokens(
                    batch, rng, tokens, max_predictions=max_predictions
                )
