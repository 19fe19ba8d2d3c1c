"""Device ms a step launched in the program's ``fwd`` region: every
layer's forward (``_regions.py``)."""
from portbench.metrics import _regions


def read(run):
    return _regions.phase(run, ("fwd",), "device_ms")
