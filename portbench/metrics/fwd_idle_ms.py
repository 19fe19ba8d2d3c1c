"""Device idle ms a step charged to the ``fwd`` region: the gaps ended
by an operation it launched (``_regions.py``)."""
from portbench.metrics import _regions


def read(run):
    return _regions.phase(run, ("fwd",), "idle_ms")
