"""Error feedback for lossy wire compression (DGC / 1-bit-SGD lineage).

A lossy wire format (float16, uint8 — core/serialization.py) drops a
quantization residual from every contributed gradient. Left alone that
residual is a per-round bias: the trunk consistently loses whatever the
codec rounds away, and with coarse formats (uint8) the loss is large enough
to bend convergence. The classic fix (Deep Gradient Compression, 1-bit SGD,
PowerSGD's EF trick) is to FEED THE RESIDUAL BACK: add the error the codec
made last round into this round's contribution before encoding, so over
time every gradient component is eventually transmitted — the cumulative
transmitted signal tracks the cumulative true gradient to within one
residual (bounded, no drift).

    contrib_t  = grad_t + residual_{t-1}
    residual_t = contrib_t - wire(contrib_t)

The residual is tracked per tensor on the host (numpy, never on device —
it rides the same jit↔asyncio seam as the averaging itself). ``wire`` here
is the codec round-trip applied per tensor; the actual all-reduce encodes
per CHUNK of the flat vector, whose uint8 quantization grid can differ
slightly at chunk boundaries — the residual is a (tight) approximation of
the true wire error, which error feedback tolerates by construction: any
mis-estimate simply lands in a later residual.

Commit discipline: ``prepare`` returns the contribution plus a ``commit``
callback, and the caller invokes commit ONLY when the round actually
averaged (a failed round transmitted nothing — updating the residual for it
would discard real gradient signal).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from dedloc_tpu_torch.core.serialization import CompressionType, wire_roundtrip


class ErrorFeedback:
    """Per-tensor residual buffer for one peer's averaging contributions."""

    def __init__(self, compression: str | CompressionType):
        self.compression = (
            CompressionType(compression)
            if isinstance(compression, str)
            else compression
        )
        self._residual: Dict[str, np.ndarray] = {}

    @property
    def enabled(self) -> bool:
        return self.compression is not CompressionType.NONE

    def prepare(
        self, named: Dict[str, np.ndarray]
    ) -> Tuple[Dict[str, np.ndarray], Callable[[], None]]:
        """Return (contribution with residual folded in, commit callback).

        The commit callback adopts this round's residual; call it only once
        the round's result actually landed. Until then the stored residual
        stays that of the last SUCCESSFUL round, so retries re-derive the
        same contribution instead of compounding."""
        if not self.enabled:
            return named, lambda: None
        contrib: Dict[str, np.ndarray] = {}
        new_residual: Dict[str, np.ndarray] = {}
        for name, grad in named.items():
            grad = np.asarray(grad, dtype=np.float32)
            res = self._residual.get(name)
            carried = grad if res is None else grad + res
            contrib[name] = carried
            new_residual[name] = carried - wire_roundtrip(
                carried, self.compression
            )

        def commit() -> None:
            self._residual = new_residual

        return contrib, commit

    def reset(self) -> None:
        """Drop the residual — after a state resync the carried error belongs
        to gradients computed on params this peer no longer holds."""
        self._residual = {}

    def residual_norm(self) -> float:
        """Global L2 norm of the stored residual (telemetry / drift tests)."""
        total = 0.0
        for res in self._residual.values():
            total += float(np.vdot(res, res).real)
        return float(np.sqrt(total))
