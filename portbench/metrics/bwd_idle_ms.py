"""Device idle ms a step charged to the ``bwd`` region: the gaps ended
by an operation launched in it (``_regions.py``)."""
from portbench.metrics import _regions


def read(run):
    return _regions.phase(run, ("bwd",), "idle_ms")
