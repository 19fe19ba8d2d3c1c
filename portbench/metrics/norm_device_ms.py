"""Device ms a step charged to the ``norm`` region in any phase: the
normalisations' forward, their recompute and their backward
(``_regions.py``)."""
from portbench.metrics import _regions


def read(run):
    t = _regions.tables(run)
    if t is None:
        return None
    return sum(row["device_ms"] for path, row in t["paths"].items()
               if "norm" in path.split("/"))
