"""THE hardened JSONL loader (one implementation, many consumers).

Real fleet logs carry exactly two corruptions worth surviving:

- a **truncated final line** (the peer was killed mid-write — the very
  churn the observability tools exist to debug): the fragment is skipped;
- **interleaved writers** (two processes appending one file can jam two
  objects onto one line, or splice one object into another): each line is
  decoded object-by-object with ``raw_decode``, salvaging every complete
  object and counting only the garbage between them.

Consumers: ``tools/runlog_summary.py`` (every telemetry view),
``tools/swarm_watch.py`` (one-shot and the --follow tail, via
``iter_line_objects``), the twin fitter's inputs, and the coordinator's
self-retune read-back of its own metrics JSONL. Keeping one copy is the
point — tolerance rules must not drift between the live and post-hoc
paths.
"""
from __future__ import annotations

import json
import sys
from typing import Callable, List, Optional, Tuple

_DECODER = json.JSONDecoder()


def iter_line_objects(line: str) -> Tuple[List[dict], int]:
    """(complete dict objects on ``line``, dropped fragment count)."""
    rows: List[dict] = []
    dropped = 0
    line = line.strip()
    while line:
        start = line.find("{")
        if start < 0:
            dropped += 1  # no object on what remains
            break
        if start > 0:
            dropped += 1  # leading garbage before the object
        try:
            obj, end = _DECODER.raw_decode(line, start)
        except json.JSONDecodeError:
            dropped += 1  # truncated/spliced fragment
            break
        if isinstance(obj, dict):
            rows.append(obj)
        line = line[end:].strip()
    return rows, dropped


def load_jsonl_rows(
    paths,
    warn: Optional[Callable[[str], None]] = None,
    missing_ok: bool = False,
) -> List[dict]:
    """All decoded dict rows from ``paths`` in file order; callers filter.
    ``warn`` receives one summary message when fragments were dropped
    (default: stderr, the CLI behavior); ``missing_ok`` skips absent files
    (the coordinator reading back a log that has not been created yet)."""
    rows: List[dict] = []
    dropped = 0
    for path in paths:
        try:
            f = open(path, encoding="utf-8", errors="replace")
        except OSError:
            if missing_ok:
                continue
            raise
        with f:
            for line in f:
                got, bad = iter_line_objects(line)
                rows.extend(got)
                dropped += bad
    if dropped:
        message = f"warning: skipped {dropped} unparseable fragment(s)"
        if warn is not None:
            warn(message)
        else:
            print(message, file=sys.stderr)
    return rows
