"""Logging helpers (reference: hivemind.utils.logging.get_logger usage and
rank-0-only verbosity, albert/run_trainer.py:36-53)."""
from __future__ import annotations

import logging
import os
import sys
import threading

_FORMAT = "[%(asctime)s.%(msecs)03d][%(levelname)s][%(name)s] %(message)s"
_configured = False
# configuration can race: the trainer thread, the DHT loop thread and a
# background backup thread all call get_logger on first use
_configure_lock = threading.Lock()


def _resolve_level(raw: str):
    """``DEDLOC_LOGLEVEL`` value -> logging level int, or None if invalid
    (numeric strings like "15" are accepted; ``setLevel`` would raise on an
    unknown NAME, so validation happens here with an INFO fallback instead
    of crashing the first logger call of the process)."""
    try:
        return int(raw)
    except ValueError:
        pass
    level = logging.getLevelName(raw)
    return level if isinstance(level, int) else None


def get_logger(name: str = "dedloc_tpu_torch") -> logging.Logger:
    global _configured
    if not _configured:
        with _configure_lock:
            if not _configured:  # double-checked: one handler, ever
                raw = os.environ.get("DEDLOC_LOGLEVEL", "INFO").upper()
                level = _resolve_level(raw)
                handler = logging.StreamHandler(sys.stderr)
                handler.setFormatter(
                    logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S")
                )
                root = logging.getLogger("dedloc_tpu_torch")
                root.addHandler(handler)
                root.setLevel(level if level is not None else logging.INFO)
                root.propagate = False
                _configured = True
                if level is None:
                    root.warning(
                        f"invalid DEDLOC_LOGLEVEL {raw!r}; falling back to "
                        "INFO"
                    )
    if not name.startswith("dedloc_tpu_torch"):
        # role CLIs run as ``python -m`` get __name__ == "__main__"; fold
        # them under the package root so they share its handler/level
        name = f"dedloc_tpu_torch.{name}"
    return logging.getLogger(name)
