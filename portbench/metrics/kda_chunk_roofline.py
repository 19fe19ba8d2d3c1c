"""The KDA chunk kernels' least time over their device time, summed over
their launches in the profiled steps (%). Each launch's least time comes
from the cell's ``[B, S, H, d_k, d_v, C]`` (``counts/kda.py``: each operand
read once and each output written once, the chunk states included, and the
products at the bf16 tensor-core peak)."""
from portbench.counts import kda
from portbench.metrics import _trace


def read(run):
    shape = (run.shapes or {}).get("kda_chunk")
    if run.profile is None or shape is None:
        return None
    bounds = kda.bounds(*shape)
    least = took = 0.0
    for name, bound in bounds.items():
        launches = _trace.kernels(run.profile, name)
        least += bound * len(launches)
        took += _trace.seconds(launches)
    return 100.0 * least / took if took else None
