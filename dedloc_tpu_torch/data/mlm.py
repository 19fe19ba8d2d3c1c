"""MLM + sentence-order-prediction instance construction and masking.

Capability parity with the reference's data prep
(albert/tokenize_wikitext103.py:13-72 ``create_instances_from_document``:
segment-pair packing with a random A/B split point and a 50% swap that
defines the SOP label; and transformers' ``DataCollatorForLanguageModeling``
masking: 15% of non-special positions get a label, of which 80% → [MASK],
10% → random token, 10% → unchanged).

Tokenizer-agnostic and TPU-first: everything operates on integer numpy
arrays (the tokenizer itself stays an external wheel — SURVEY.md §2.7), and
masking is vectorized over the whole batch so the host never loops per
token. All outputs are fixed-shape, jit-ready arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    cls_id: int = 2
    sep_id: int = 3
    pad_id: int = 0
    mask_id: int = 4
    vocab_size: int = 30000
    # ids < num_reserved are never used as random replacements
    num_reserved: int = 5


def create_instances_from_document(
    sentences: Sequence[Sequence[int]],
    max_seq_length: int,
    rng: np.random.Generator,
    tokens: SpecialTokens,
) -> List[Dict[str, np.ndarray]]:
    """Pack one document's tokenized sentences into MLM+SOP instances.

    Mirrors tokenize_wikitext103.py:13-72: greedily fill ``current_chunk`` to
    ``max_seq_length - 3`` (CLS + 2×SEP), choose a random sentence boundary
    ``a_end`` to split segments A|B, swap A and B with probability 0.5
    (``sentence_order_label`` 1 when swapped), emit
    ``[CLS] A [SEP] B [SEP]`` with token-type ids 0…0 1…1.
    """
    target_len = max_seq_length - 3
    instances: List[Dict[str, np.ndarray]] = []
    current: List[Sequence[int]] = []
    current_len = 0

    def flush() -> None:
        nonlocal current, current_len
        if not current:
            return
        if len(current) == 1:
            segment_a, segment_b = list(current[0]), []
        else:
            a_end = int(rng.integers(1, len(current)))
            segment_a = [t for s in current[:a_end] for t in s]
            segment_b = [t for s in current[a_end:] for t in s]
        label = 0
        if segment_b and rng.random() < 0.5:
            segment_a, segment_b = segment_b, segment_a
            label = 1
        # truncate the pair to fit (front-biased like the reference's
        # truncate_seq_pair capability: drop from the longer segment)
        while len(segment_a) + len(segment_b) > target_len:
            longer = segment_a if len(segment_a) >= len(segment_b) else segment_b
            longer.pop()
        ids = (
            [tokens.cls_id]
            + segment_a
            + [tokens.sep_id]
            + segment_b
            + [tokens.sep_id]
        )
        type_ids = [0] * (len(segment_a) + 2) + [1] * (len(segment_b) + 1)
        special = (
            [1] + [0] * len(segment_a) + [1] + [0] * len(segment_b) + [1]
        )
        instances.append(
            {
                "input_ids": np.asarray(ids, np.int32),
                "token_type_ids": np.asarray(type_ids, np.int32),
                "special_tokens_mask": np.asarray(special, np.int32),
                "sop_label": np.asarray(label, np.int32),
            }
        )
        current, current_len = [], 0

    for sentence in sentences:
        if not len(sentence):
            continue
        current.append(sentence)
        current_len += len(sentence)
        if current_len >= target_len:
            flush()
    flush()
    return instances


def pad_and_batch(
    instances: Sequence[Dict[str, np.ndarray]],
    max_seq_length: int,
    tokens: SpecialTokens,
) -> Dict[str, np.ndarray]:
    """Stack variable-length instances into fixed [B, S] arrays (+mask)."""
    b = len(instances)
    out = {
        "input_ids": np.full((b, max_seq_length), tokens.pad_id, np.int32),
        "token_type_ids": np.zeros((b, max_seq_length), np.int32),
        "special_tokens_mask": np.ones((b, max_seq_length), np.int32),
        "attention_mask": np.zeros((b, max_seq_length), np.int32),
        "sop_labels": np.zeros((b,), np.int32),
    }
    for i, inst in enumerate(instances):
        n = min(len(inst["input_ids"]), max_seq_length)
        out["input_ids"][i, :n] = inst["input_ids"][:n]
        out["token_type_ids"][i, :n] = inst["token_type_ids"][:n]
        out["special_tokens_mask"][i, :n] = inst["special_tokens_mask"][:n]
        out["attention_mask"][i, :n] = 1
        out["sop_labels"][i] = inst["sop_label"]
    return out


def max_predictions_for(seq_length: int, mlm_probability: float = 0.15) -> int:
    """Gathered-label capacity for a sequence length: the expected masked
    count plus slack so sampling jitter never truncates labels. The single
    source of truth — every producer of ``mlm_positions`` and every consumer
    sizing the gathered head must agree on this width or shapes recompile."""
    return int(seq_length * mlm_probability) + 4


def mask_tokens(
    batch: Dict[str, np.ndarray],
    rng: np.random.Generator,
    tokens: SpecialTokens,
    mlm_probability: float = 0.15,
    ignore_index: int = -100,
    max_predictions: int = 0,
) -> Dict[str, np.ndarray]:
    """Whole-batch vectorized MLM masking (DataCollatorForLanguageModeling
    semantics): 15% of maskable positions become labels; 80% of those are
    replaced by [MASK], 10% by a random non-special token, 10% kept.

    With ``max_predictions > 0`` the batch additionally carries the gathered
    TPU-native label layout — ``mlm_positions``/``mlm_label_ids``/
    ``mlm_weights`` [B, max_predictions] — so the model can run the vocab
    projection on prediction positions only. Labelled positions beyond
    ``max_predictions`` are demoted back to unlabelled (and unmasked), so
    the two layouts stay consistent.
    """
    input_ids = batch["input_ids"]
    maskable = (batch["special_tokens_mask"] == 0) & (batch["attention_mask"] == 1)
    probs = rng.random(input_ids.shape)
    labelled = (probs < mlm_probability) & maskable

    if max_predictions:
        # keep at most max_predictions labels per row (drop the excess)
        cum = np.cumsum(labelled, axis=1)
        labelled &= cum <= max_predictions

    mlm_labels = np.where(labelled, input_ids, ignore_index).astype(np.int32)

    action = rng.random(input_ids.shape)
    masked = labelled & (action < 0.8)
    randomized = labelled & (action >= 0.8) & (action < 0.9)
    random_ids = rng.integers(
        tokens.num_reserved, tokens.vocab_size, input_ids.shape
    ).astype(np.int32)

    new_ids = np.where(masked, tokens.mask_id, input_ids)
    new_ids = np.where(randomized, random_ids, new_ids).astype(np.int32)

    out = dict(batch)
    out["input_ids"] = new_ids
    out["mlm_labels"] = mlm_labels
    if max_predictions:
        b, s = input_ids.shape
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
