"""Device time per profiled step in kernels outside the port's and the
library's matmuls and convolutions (normalisations, elementwise, casts,
reductions), in ms."""
from portbench.metrics import _trace


def read(run):
    if run.profile is None:
        return None
    other = [e for e in run.profile["events"] if _trace.kind(e) == "other"]
    return _trace.seconds(other) / run.profile["steps"] * 1e3
