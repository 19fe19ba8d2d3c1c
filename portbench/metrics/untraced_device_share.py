"""Share (%) of the stretch's device time launched outside every
``dedloc.`` region of the program: how much of the device's work the
regions cover (``_regions.py``)."""
from portbench.metrics import _regions


def read(run):
    t = _regions.tables(run)
    if t is None or not t["busy_ms"]:
        return None
    return 100.0 * t["untraced"]["device_ms"] / t["busy_ms"]
