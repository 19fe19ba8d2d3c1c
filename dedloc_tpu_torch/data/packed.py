"""Packed causal-LM batches: documents joined with an EOS id and cut to the
sequence length, each position labelled with the next token.

Synthetic documents stand in for a corpus: log-normal lengths (median
``median_length``, ``sigma``, capped at the sequence length) of ids drawn
from a Zipf law (``p(r) ~ r^-zipf_s`` over ranks 1 .. V-1, the id of rank
r being r) so that frequent ids, and so the experts they route to, recur
as they do in text. Id ``EOS_ID`` (0) ends every document. A micro-batch
of B rows of S positions takes B * S + 1 ids of the stream: row i holds
ids ``[i S, (i + 1) S)`` and its labels ``[i S + 1, (i + 1) S + 1)``, so
every position has a label and a row may start inside a document. Numpy on
the host; the same seed gives the same stream.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

EOS_ID = 0


def zipf_cdf(vocab_size: int, s: float) -> np.ndarray:
    """The cumulative probabilities of ranks 1 .. V-1."""
    weights = np.arange(1, vocab_size, dtype=np.float64) ** -s
    return np.cumsum(weights) / weights.sum()


def document_stream(rng: np.random.Generator, n: int, seq_length: int, cdf: np.ndarray,
                    median_length: float, sigma: float) -> np.ndarray:
    """At least ``n`` ids of documents, each followed by ``EOS_ID``."""
    out, total = [], 0
    while total < n:
        length = int(min(seq_length, max(1, round(rng.lognormal(np.log(median_length),
                                                                 sigma)))))
        ids = np.searchsorted(cdf, rng.random(length), side="right") + 1
        out.append(np.minimum(ids, len(cdf)).astype(np.int32))
        out.append(np.array([EOS_ID], np.int32))
        total += length + 1
    return np.concatenate(out)[:n]


def packed_lm_batches(vocab_size: int, batch_size: int, seq_length: int, seed: int,
                      median_length: float = 1024.0, sigma: float = 1.0,
                      zipf_s: float = 1.1) -> Iterator[Dict[str, np.ndarray]]:
    """Each yield: ``input_ids`` and ``labels``, int32 ``[B, S]``."""
    rng = np.random.default_rng(seed)
    cdf = zipf_cdf(vocab_size, zipf_s)
    n = batch_size * seq_length
    while True:
        stream = document_stream(rng, n + 1, seq_length, cdf, median_length, sigma)
        yield {"input_ids": stream[:n].reshape(batch_size, seq_length),
               "labels": stream[1:].reshape(batch_size, seq_length)}
