"""Synthetic MLM + sentence-order micro-batches from a seed.

A frozen copy of the port's ``roles/common.py`` ``synthetic_mlm_batches``
with ``data/mlm.py`` ``mask_tokens`` (DataCollatorForLanguageModeling
semantics: 15% of maskable positions labelled, 80% of them [MASK], 10% a
random id, 10% kept; at most ``int(0.15 * S) + 4`` predictions a row in the
gathered layout). Numpy on the host; the same seed gives the same stream.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

CLS_ID, SEP_ID, PAD_ID, MASK_ID = 2, 3, 0, 4
NUM_RESERVED = 5  # ids below this are never drawn as tokens


def max_predictions_for(seq_length: int, mlm_probability: float = 0.15) -> int:
    return int(seq_length * mlm_probability) + 4


def mask_tokens(batch: Dict[str, np.ndarray], rng: np.random.Generator,
                vocab_size: int, max_predictions: int,
                mlm_probability: float = 0.15, ignore_index: int = -100
                ) -> Dict[str, np.ndarray]:
    input_ids = batch["input_ids"]
    maskable = (batch["special_tokens_mask"] == 0) & (batch["attention_mask"] == 1)
    probs = rng.random(input_ids.shape)
    labelled = (probs < mlm_probability) & maskable
    cum = np.cumsum(labelled, axis=1)
    labelled &= cum <= max_predictions
    mlm_labels = np.where(labelled, input_ids, ignore_index).astype(np.int32)
    action = rng.random(input_ids.shape)
    masked = labelled & (action < 0.8)
    randomized = labelled & (action >= 0.8) & (action < 0.9)
    random_ids = rng.integers(NUM_RESERVED, vocab_size, input_ids.shape).astype(np.int32)
    new_ids = np.where(masked, MASK_ID, input_ids)
    new_ids = np.where(randomized, random_ids, new_ids).astype(np.int32)
    out = dict(batch)
    out["input_ids"] = new_ids
    out["mlm_labels"] = mlm_labels
    b, _s = input_ids.shape
    positions = np.zeros((b, max_predictions), np.int32)
    label_ids = np.zeros((b, max_predictions), np.int32)
    weights = np.zeros((b, max_predictions), np.float32)
    for i in range(b):
        idx = np.flatnonzero(labelled[i])
        n = len(idx)
        positions[i, :n] = idx
        label_ids[i, :n] = input_ids[i, idx]
        weights[i, :n] = 1.0
    out["mlm_positions"] = positions
    out["mlm_label_ids"] = label_ids
    out["mlm_weights"] = weights
    return out


def synthetic_mlm_batches(vocab_size: int, batch_size: int, seq_length: int,
                          seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """Random token documents of ``seq_length`` through the masking path;
    each yield is one micro-batch of ``batch_size`` rows."""
    rng = np.random.default_rng(seed)
    max_predictions = max_predictions_for(seq_length)
    while True:
        ids = rng.integers(NUM_RESERVED, vocab_size,
                           (batch_size, seq_length)).astype(np.int32)
        batch = {
            "input_ids": ids,
            "attention_mask": np.ones((batch_size, seq_length), np.int32),
            "token_type_ids": np.zeros((batch_size, seq_length), np.int32),
            "special_tokens_mask": np.zeros((batch_size, seq_length), np.int32),
            "sop_labels": rng.integers(0, 2, (batch_size,)).astype(np.int32),
        }
        yield mask_tokens(batch, rng, vocab_size, max_predictions)


def pool(traffic: dict, config: dict, seed: int) -> list:
    """``traffic["pool"]`` micro-batches of ``micro_batch`` x ``seq_length``
    over the configuration's vocabulary."""
    gen = synthetic_mlm_batches(config["vocab_size"], traffic["micro_batch"],
                                traffic["seq_length"], seed % 2 ** 63)
    return [next(gen) for _ in range(traffic["pool"])]
