"""Pure-numpy evaluation metrics for downstream tasks.

Replaces the reference's external metric dependencies: ``seqeval`` entity-span
precision/recall/F1 (train_ner.py uses load_metric("seqeval")) and
``accuracy`` (train_ncc.py:197). Span extraction follows the IOB2/BIO scheme
seqeval defaults to: an entity is a maximal run ``B-X (I-X)*``; a bare ``I-X``
(or an ``I-X`` after a different type) opens a new entity, matching seqeval's
lenient default mode.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

Entity = Tuple[str, int, int]  # (type, start, end_exclusive)


def extract_entities(tags: Sequence[str]) -> Set[Entity]:
    """BIO tag sequence -> set of (type, start, end) spans."""
    entities: Set[Entity] = set()
    start = None
    etype = None
    for i, tag in enumerate(tags):
        if tag.startswith("B-"):
            if start is not None:
                entities.add((etype, start, i))
            start, etype = i, tag[2:]
        elif tag.startswith("I-"):
            if start is None or etype != tag[2:]:
                # orphan continuation: seqeval's default counts it as a span
                if start is not None:
                    entities.add((etype, start, i))
                start, etype = i, tag[2:]
        else:  # "O" or anything else closes the open span
            if start is not None:
                entities.add((etype, start, i))
                start, etype = None, None
    if start is not None:
        entities.add((etype, start, len(tags)))
    return entities


def span_f1(
    predictions: Sequence[Sequence[str]], references: Sequence[Sequence[str]]
) -> Dict[str, float]:
    """Micro precision/recall/F1 over entity spans + token accuracy."""
    assert len(predictions) == len(references)
    tp = fp = fn = 0
    correct = total = 0
    for pred, ref in zip(predictions, references):
        assert len(pred) == len(ref)
        p_ents = extract_entities(pred)
        r_ents = extract_entities(ref)
        tp += len(p_ents & r_ents)
        fp += len(p_ents - r_ents)
        fn += len(r_ents - p_ents)
        correct += sum(p == r for p, r in zip(pred, ref))
        total += len(ref)
    precision = tp / max(1, tp + fp)
    recall = tp / max(1, tp + fn)
    f1 = 2 * precision * recall / max(1e-12, precision + recall)
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "accuracy": correct / max(1, total),
    }


def accuracy_score(predictions: Sequence[int], references: Sequence[int]) -> float:
    assert len(predictions) == len(references)
    if not references:
        return 0.0
    return sum(p == r for p, r in zip(predictions, references)) / len(references)


def align_labels_with_words(
    word_ids: Sequence[object],
    word_labels: Sequence[int],
    label_all_tokens: bool = False,
    ignore_index: int = -100,
) -> List[int]:
    """Word-level labels -> token-level labels via the tokenizer's word_ids.

    The label-alignment rule of train_ner.py:184-212: special tokens
    (word_id None) get -100; the first sub-token of each word gets the word's
    label; continuation sub-tokens get the label if ``label_all_tokens`` else
    -100.
    """
    out: List[int] = []
    prev = None
    for wid in word_ids:
        if wid is None:
            out.append(ignore_index)
        elif wid != prev:
            out.append(word_labels[wid])
        else:
            out.append(word_labels[wid] if label_all_tokens else ignore_index)
        prev = wid
    return out
