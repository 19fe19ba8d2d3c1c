"""The least time of one launch of each causal two-width flash kernel
(latent attention: q and k ``dqk`` wide, v and out ``dv`` wide), counted
from its shapes.

Only the work at or below the diagonal is charged: ``S (S + 1) / 2``
(query, key) pairs a head, each with its products and one exponential.
Per pair the forward does S = Q.K^T (2 dqk operations) and O += P.V
(2 dv); dK/dV recomputes S^T and dP^T = V.dO^T and accumulates dV and dK
(4 dqk + 4 dv); dQ recomputes S and dP and accumulates dQ (4 dqk + 2 dv).
Bytes: each input read once and each output written once, in bf16 for
q, k, v, out, dO and the gradients, fp32 for the row statistics (lse,
delta). The least time is the largest of the bytes over the HBM rate,
the operations over the bf16 tensor-core peak and the exponentials over
the special-function units' rate (``roofline.bound_s``).
"""
from __future__ import annotations

from typing import Dict

from portbench.counts import h100
from portbench.counts.roofline import bound_s

KERNELS = ("flash_mla_fwd_kernel", "flash_mla_bwd_dkdv_kernel", "flash_mla_bwd_dq_kernel")


def pairs(b: int, s: int, h: int) -> int:
    """(query, key) pairs at or below the diagonal, over every head."""
    return b * h * s * (s + 1) // 2


def bounds(b: int, s: int, h: int, dqk: int, dv: int, exp_per_s: float
           ) -> Dict[str, float]:
    """Seconds per launch of each kernel at [B, S, H] in bf16."""
    n = pairs(b, s, h)
    qk = b * s * h * dqk * 2  # one bf16 [B, S, H, dqk] tensor
    vo = b * s * h * dv * 2  # one bf16 [B, S, H, dv] tensor
    rows = b * h * s * 4  # one fp32 [B*H, S] row tensor

    def least(n_bytes: float, ops_per_pair: int) -> float:
        return bound_s(n_bytes, tensor_cores=n * ops_per_pair / h100.BF16_FLOPS,
                       mufu_exp=n / exp_per_s)

    return {
        "flash_mla_fwd_kernel": least(2 * qk + 2 * vo + rows, 2 * dqk + 2 * dv),
        "flash_mla_bwd_dkdv_kernel": least(3 * qk + 3 * vo + 2 * rows,
                                           4 * dqk + 4 * dv),
        "flash_mla_bwd_dq_kernel": least(3 * qk + 2 * vo + 2 * rows, 4 * dqk + 2 * dv),
    }
