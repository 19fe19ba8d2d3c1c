"""Device ms a step launched in the program's ``bwd`` region, the remat
recompute included (``_regions.py``)."""
from portbench.metrics import _regions


def read(run):
    return _regions.phase(run, ("bwd",), "device_ms")
