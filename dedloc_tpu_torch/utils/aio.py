"""Small asyncio utilities shared across the DHT/averaging/simulator stack.

``keep_task`` is the approved answer to dedlint's ``async-orphan-task``
rule: a bare ``asyncio.ensure_future(coro())`` keeps no strong reference —
the loop only holds a weak one, so the task can be garbage-collected
mid-flight, and an exception inside it is silently parked until interpreter
shutdown prints "Task exception was never retrieved" (the PR 7
catalog-announce flake class). Background work that is deliberately not
awaited must still be retained and must still surface its failures.
"""
from __future__ import annotations

import asyncio
from typing import Coroutine, Optional, Set

from dedloc_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# strong references to in-flight background tasks; each task discards
# itself on completion, so the set stays bounded by actual concurrency.
# Tasks whose loop was closed/abandoned mid-flight never run their done-
# callback, so a periodic sweep (below) prunes them — without it, per-test
# loop churn would grow the set monotonically for the process lifetime.
# The cadence is deliberately coarse: each sweep is O(live tasks), and a
# large simulation legitimately keeps tens of thousands of parked acceptor
# tasks alive — sweeping those every 512 spawns was pure overhead. Memory
# growth between sweeps stays bounded by _SWEEP_EVERY dead-loop tasks.
_background: Set["asyncio.Future"] = set()
_SWEEP_EVERY = 8192
_spawn_count = 0


def _sweep_dead_loops() -> None:
    for t in list(_background):
        try:
            if t.get_loop().is_closed():
                _background.discard(t)
        except RuntimeError:  # detached future
            _background.discard(t)


def keep_task(
    coro_or_future, name: str = "", log: Optional[object] = None
) -> "asyncio.Future":
    """Schedule background work WITH a retained handle and a done-callback
    that logs any exception (CancelledError excluded — cancellation is how
    owners shut background work down, not a failure).

    Returns the task so callers that also want the handle (e.g. to cancel
    on close) can keep it; retention here does not depend on them doing so.
    """
    global _spawn_count
    _spawn_count += 1
    if _spawn_count % _SWEEP_EVERY == 0:
        _sweep_dead_loops()
    task = asyncio.ensure_future(coro_or_future)
    _background.add(task)
    task_log = log if log is not None else logger
    label = name or getattr(coro_or_future, "__qualname__", "") or "task"

    def _done(t: "asyncio.Future") -> None:
        _background.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            # exc_info keeps the traceback the default "Task exception was
            # never retrieved" handler would have printed
            task_log.warning(
                f"background {label} failed: {exc!r}", exc_info=exc
            )

    task.add_done_callback(_done)
    return task
