"""The least time the card could take for one launch of a port kernel,
counted from its shapes: a frozen copy of ``chip_smoke.py``'s ``bound``
and ``attention_bound`` and of the byte and operation counts of its
kernel table.

Each input byte is counted read once and each output byte written once.
The least time is the largest of the bytes over the HBM rate and each kind
of operation over its unit's peak.
"""
from __future__ import annotations

from typing import Dict

from portbench.counts import h100


def bound_s(n_bytes: float, **ops_s: float) -> float:
    """Seconds: the bytes over the HBM rate, or each kind of operation's
    seconds (``ops_s``, by unit), whichever is largest."""
    return max([n_bytes / h100.HBM_BYTES_PER_S, *ops_s.values()])


def attention_bound_s(n_bytes: float, products: int, mm: float, n_exp: float,
                      exp_per_s: float) -> float:
    """A flash kernel: ``products`` S x S x D matmuls of ``mm`` operations
    each on the bf16 tensor cores, ``n_exp`` exponentials, ``n_bytes``."""
    return bound_s(n_bytes, tensor_cores=products * mm / h100.BF16_FLOPS,
                   mufu_exp=n_exp / exp_per_s)


def flash_bounds(b: int, s: int, h: int, d: int, exp_per_s: float) -> Dict[str, float]:
    """Seconds per launch of each flash kernel at [B, S, H, D] in bf16:
    the forward reads q, k, v and the key bias and writes out and the
    row log-sum-exp (2 products); dK/dV reads q, k, v, dO, lse, delta and
    the bias and writes dk, dv (4 products, s and dp recomputed); dQ
    writes dq (3 products)."""
    io = b * s * h * d * 2  # one bf16 [B, S, H, D] tensor
    rows = b * h * s * 4  # one fp32 [B*H, S] row tensor
    mm = 2 * b * h * s * s * d  # one S x S x D matmul
    n_exp = b * h * s * s
    return {
        "flash_fwd_kernel": attention_bound_s(4 * io + b * s * 4 + rows, 2, mm,
                                              n_exp, exp_per_s),
        "flash_bwd_dkdv_kernel": attention_bound_s(6 * io + 2 * rows + b * s * 4,
                                                   4, mm, n_exp, exp_per_s),
        "flash_bwd_dq_kernel": attention_bound_s(5 * io + 2 * rows + b * s * 4,
                                                 3, mm, n_exp, exp_per_s),
    }


def ln_bounds(n: int, w: int) -> Dict[str, float]:
    """Seconds per call of the fused add+LayerNorm on [N, W] bf16 rows:
    the forward with its residuals (reads x, r, gamma, beta; writes y,
    x-hat, rstd; 10 fp32 operations an element) and the backward pair
    ``_ln_bwd_kernel`` + ``_ln_reduce_kernel`` (reads x-hat, rstd, dy,
    gamma; writes da, dgamma, dbeta; 12 an element)."""
    row = n * w * 2
    return {
        "forward": bound_s(4 * row + 2 * w * 4 + n * 4,
                           fp32=10 * n * w / h100.FP32_FLOPS),
        "backward": bound_s(3 * row + n * 4 + 3 * w * 4,
                            fp32=12 * n * w / h100.FP32_FLOPS),
    }
