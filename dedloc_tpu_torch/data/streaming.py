"""Streaming dataset combinators: weighted interleave + seeded shuffle buffer.

Capability parity with sahajbert/dataset_streaming.py:98-139: a lazy mix of
two text sources with probabilities (wiki 23% / oscar 77%), a shuffle buffer
of 10^4 examples seeded PER PEER (``shuffle_seed = hash(local_public_key) %
2**31``, sahajbert/run_trainer.py:268-270 — peers must not see identical
batches), and an infinite wrapper that restarts exhausted sources.

Source-agnostic: combinators take any iterables/factories, so they work over
HF streaming datasets, local files, or synthetic generators (the §4 fixture
pattern) without importing `datasets` here.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def peer_shuffle_seed(peer_public_key: bytes) -> int:
    """Deterministic per-peer seed (run_trainer.py:268-270 capability —
    stable across runs, unlike Python's salted hash())."""
    import hashlib

    return int.from_bytes(
        hashlib.sha256(peer_public_key).digest()[:4], "little"
    ) % (2**31)


def interleave_weighted(
    sources: Sequence[Iterable[Any]],
    probabilities: Sequence[float],
    seed: int = 0,
) -> Iterator[Any]:
    """Sample the next example from source i with probability p_i
    (merge_datasets(probabilities=...) capability, dataset_streaming.py:127).
    An exhausted source's probability is redistributed to the others."""
    assert len(sources) == len(probabilities) > 0
    rng = np.random.default_rng(seed)
    iters: List[Optional[Iterator[Any]]] = [iter(s) for s in sources]
    probs = np.asarray(probabilities, np.float64)
    probs = probs / probs.sum()
    while any(it is not None for it in iters):
        live = [i for i, it in enumerate(iters) if it is not None]
        p = probs[live] / probs[live].sum()
        choice = int(rng.choice(live, p=p))
        try:
            yield next(iters[choice])  # type: ignore[arg-type]
        except StopIteration:
            iters[choice] = None


class ShuffleBuffer:
    """Reservoir-style shuffle buffer (buffer_size 10^4 in the reference,
    dataset_streaming.py:131): fill the buffer, then yield a random slot and
    replace it with the next upstream example."""

    def __init__(self, buffer_size: int = 10_000, seed: int = 0):
        self.buffer_size = buffer_size
        self.seed = seed

    def __call__(self, source: Iterable[Any]) -> Iterator[Any]:
        rng = np.random.default_rng(self.seed)
        buf: List[Any] = []
        for item in source:
            if len(buf) < self.buffer_size:
                buf.append(item)
                continue
            idx = int(rng.integers(0, len(buf)))
            yield buf[idx]
            buf[idx] = item
        rng.shuffle(buf)
        yield from buf


def repeat_forever(factory: Callable[[], Iterable[Any]]) -> Iterator[Any]:
    """Infinite stream over a restartable source (WrappedIterableDataset
    capability, dataset_streaming.py:105-113: training never stops at epoch
    boundaries; a crashed/exhausted source is simply reopened)."""
    while True:
        produced = False
        try:
            for item in factory():
                produced = True
                yield item
        except Exception as e:  # noqa: BLE001 — streaming sources flake
            logger.warning(f"stream source failed ({e!r}); reopening")
        if not produced:
            # avoid a hot loop on a permanently-empty source
            raise RuntimeError("stream source yielded no examples")


def batched(source: Iterable[Any], batch_size: int) -> Iterator[List[Any]]:
    """Group a stream into fixed-size lists (drops the trailing partial)."""
    it = iter(source)
    while True:
        chunk = list(itertools.islice(it, batch_size))
        if len(chunk) < batch_size:
            return
        yield chunk


def split_sentences(text: str, delimiters: str = ".!?।") -> List[str]:
    """Delimiter-based sentence splitting (the Bengali danda ``।`` included —
    dataset_streaming.py:33 handles it via bnlp; this is the dependency-free
    equivalent). Keeps the delimiter attached to its sentence."""
    sentences: List[str] = []
    current: List[str] = []
    for ch in text:
        current.append(ch)
        if ch in delimiters:
            s = "".join(current).strip()
            if s:
                sentences.append(s)
            current = []
    tail = "".join(current).strip()
    if tail:
        sentences.append(tail)
    return sentences


def text_file_source(path: str) -> Callable[[], Iterable[str]]:
    """Restartable one-document-per-line reader for ``repeat_forever``."""

    def factory() -> Iterator[str]:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line

    return factory


def http_text_source(
    url: str,
    *,
    timeout: float = 30.0,
    max_retries: int = 5,
    backoff: float = 1.0,
    chunk_size: int = 64 * 1024,
) -> Callable[[], Iterable[str]]:
    """Restartable one-document-per-line reader over HTTP(S) — the remote
    streaming capability of the reference's wiki+oscar mix
    (sahajbert/dataset_streaming.py:116-139 streams both over HTTP).

    Mid-stream failures RESUME: the reader tracks the byte offset of fully
    consumed lines and reconnects with a ``Range`` request after an
    exponentially backed-off retry; a server without Range support is
    re-read from the start with the consumed prefix skipped. Lines are
    yielded exactly once either way."""

    def factory() -> Iterator[str]:
        import http.client
        import time as _time
        import urllib.error
        import urllib.request

        offset = 0  # bytes of COMPLETE lines already yielded
        retries = 0
        while True:
            req = urllib.request.Request(url)
            if offset:
                req.add_header("Range", f"bytes={offset}-")
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    skip = offset if (offset and resp.status != 206) else 0
                    expected = int(resp.headers.get("Content-Length") or -1)
                    received = 0
                    buf = b""
                    while True:
                        chunk = resp.read(chunk_size)
                        if not chunk:
                            if 0 <= received < expected:
                                # server closed early (advertised more):
                                # NOT end-of-stream — resume from offset
                                raise ConnectionError(
                                    f"short read: {received}/{expected}"
                                )
                            tail = buf.decode("utf-8", "replace").strip()
                            if tail:
                                yield tail
                            return
                        received += len(chunk)
                        if skip:
                            drop = min(skip, len(chunk))
                            chunk = chunk[drop:]
                            skip -= drop
                            if not chunk:
                                continue
                        buf += chunk
                        while b"\n" in buf:
                            raw, buf = buf.split(b"\n", 1)
                            offset += len(raw) + 1
                            retries = 0  # progress => reset the budget
                            line = raw.decode("utf-8", "replace").strip()
                            if line:
                                yield line
            except (urllib.error.URLError, ConnectionError, TimeoutError,
                    OSError, http.client.HTTPException) as e:
                retries += 1
                if retries > max_retries:
                    raise
                logger.warning(
                    f"http stream {url} failed ({e!r}); "
                    f"resuming at byte {offset} (retry {retries})"
                )
                _time.sleep(backoff * retries)

    return factory


def make_text_source(spec: str) -> Callable[[], Iterable[str]]:
    """Source from a spec string: ``http(s)://`` URLs stream remotely with
    retry/resume; anything else is a local one-document-per-line file."""
    if spec.startswith(("http://", "https://")):
        return http_text_source(spec)
    return text_file_source(spec)


def prefetch(source: Iterable[Any], size: int = 64) -> Iterator[Any]:
    """Bounded background prefetch: a daemon thread pulls up to ``size``
    items ahead so network/tokenization latency overlaps the consumer
    (the accelerator step). Exceptions re-raise at the consumption point."""
    import queue
    import threading

    q: "queue.Queue[Any]" = queue.Queue(maxsize=size)
    _END = object()

    def worker() -> None:
        try:
            for item in source:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def streaming_mlm_batches(
    text_sources: Sequence[Callable[[], Iterable[str]]],
    weights: Sequence[float],
    tokenize_sentences: Callable[[str], List[List[int]]],
    tokens,
    batch_size: int,
    max_seq_length: int,
    seed: int,
    buffer_size: int = 10_000,
    max_predictions: int = 0,
) -> Iterator[dict]:
    """The full streaming pipeline (make_lazy_wikioscar_dataset capability,
    dataset_streaming.py:116-139): weighted lazy mix of restartable document
    sources -> per-peer-seeded shuffle buffer -> on-the-fly MLM+SOP instance
    building -> fixed-shape masked batches. Infinite; never epoch-bounded."""
    from dedloc_tpu_torch.data.mlm import (
        create_instances_from_document,
        mask_tokens,
        pad_and_batch,
    )

    rng = np.random.default_rng(seed)

    def instance_stream() -> Iterator[dict]:
        sources = [repeat_forever(f) for f in text_sources]
        for doc in interleave_weighted(sources, weights, seed=seed):
            sentences = tokenize_sentences(doc)
            yield from create_instances_from_document(
                sentences, max_seq_length, rng, tokens
            )

    shuffled = ShuffleBuffer(buffer_size, seed=seed)(instance_stream())
    for group in batched(shuffled, batch_size):
        batch = pad_and_batch(group, max_seq_length, tokens)
        yield mask_tokens(
            batch, rng, tokens, max_predictions=max_predictions
        )
