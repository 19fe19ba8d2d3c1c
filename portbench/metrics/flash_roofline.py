"""The flash kernels' least time over their device time, summed over
their launches in the profiled steps (%). Each launch's least time comes
from the cell's [B, S, H, D] (``counts/roofline.py``)."""
from portbench.counts import roofline
from portbench.metrics import _trace


def read(run):
    shape = run.shapes.get("flash")
    if run.profile is None or shape is None or not run.exp_per_s:
        return None
    bounds = roofline.flash_bounds(*shape, exp_per_s=run.exp_per_s)
    least = took = 0.0
    for name, bound in bounds.items():
        launches = _trace.kernels(run.profile, name)
        least += bound * len(launches)
        took += _trace.seconds(launches)
    return 100.0 * least / took if took else None
