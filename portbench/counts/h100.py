"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the yardstick every roofline and
MFU share of the benchmark is taken against.

The exponential rate is the special-function units' (16 exp2 results per
clock per SM on sm_90), so it depends on the card's SM count and maximum
SM clock, which the harness reads from the card it runs on.
"""
from __future__ import annotations

BF16_FLOPS = 989e12  # dense bf16 / fp16 tensor-core operations per second
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
MUFU_PER_CLOCK = 16  # exp2 results per clock per SM


def exp_per_s(sm_count: int, max_sm_mhz: float) -> float:
    """Exponentials per second of a card with ``sm_count`` SMs at its
    maximum SM clock."""
    return MUFU_PER_CLOCK * sm_count * max_sm_mhz * 1e6
