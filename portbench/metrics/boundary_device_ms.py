"""Device ms a step launched in the boundary's regions, ``mean_clip`` and
``opt_apply`` (``_regions.py``)."""
from portbench.metrics import _regions


def read(run):
    return _regions.phase(run, _regions.BOUNDARY, "device_ms")
