"""The causal two-width flash kernels' least time over their device time,
summed over their launches in the profiled steps (%). Each launch's least
time comes from the cell's [B, S, H, D_QK, D_V] with only the work at or
below the diagonal charged (``counts/causal_flash.py``)."""
from portbench.counts import causal_flash
from portbench.metrics import _trace


def read(run):
    shape = (run.shapes or {}).get("mla_flash")
    if run.profile is None or shape is None or not run.exp_per_s:
        return None
    bounds = causal_flash.bounds(*shape, exp_per_s=run.exp_per_s)
    least = took = 0.0
    for name, bound in bounds.items():
        launches = _trace.kernels(run.profile, name)
        least += bound * len(launches)
        took += _trace.seconds(launches)
    return 100.0 * least / took if took else None
