"""MLM masking for the port (numpy, no framework).

Copy of the parts of ``dedloc_tpu/data/mlm.py`` the training slice uses:
``SpecialTokens``, ``max_predictions_for`` and ``mask_tokens``
(DataCollatorForLanguageModeling semantics: 15% of maskable positions get a
label; 80% of those become [MASK], 10% a random token, 10% stay), with the
gathered label layout the model's masked-position head consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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


def max_predictions_for(seq_length: int, mlm_probability: float = 0.15) -> int:
    """Gathered-label capacity for a sequence length: the expected masked
    count plus slack so sampling jitter never truncates labels."""
    return int(seq_length * mlm_probability) + 4


def mask_tokens(
    batch: Dict[str, np.ndarray],
    rng: np.random.Generator,
    tokens: SpecialTokens,
    mlm_probability: float = 0.15,
    ignore_index: int = -100,
    max_predictions: int = 0,
) -> Dict[str, np.ndarray]:
    """Whole-batch vectorized MLM masking. With ``max_predictions > 0`` the
    batch also carries ``mlm_positions``/``mlm_label_ids``/``mlm_weights``
    [B, max_predictions]; labelled positions beyond ``max_predictions`` are
    demoted back to unlabelled (and unmasked), so the two layouts agree."""
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
        b, _ = input_ids.shape
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
