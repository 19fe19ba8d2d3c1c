"""Device ms a step charged to the ``moe`` region in any phase: the expert
layers' routing, dispatch, grouped expert products, combine and shared
experts, in their forward, recompute and backward (``_regions.py``)."""
from portbench.metrics import _regions


def read(run):
    t = _regions.tables(run)
    if t is None:
        return None
    rows = [row for path, row in t["paths"].items() if "moe" in path.split("/")]
    return sum(row["device_ms"] for row in rows) if rows else None
