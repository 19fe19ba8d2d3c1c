"""Analytic model FLOPs of the traced window's steps over its wall time
and the H100's 989 TFLOP/s (bf16 dense), in %."""
from portbench.counts import h100


def read(run):
    if not run.flops_per_step:
        return None
    return 100.0 * run.steps * run.flops_per_step / run.window_s / h100.BF16_FLOPS
