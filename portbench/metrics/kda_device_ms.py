"""Device ms a step charged to the ``kda`` region in any phase: the KDA
layers' projections, short convolutions, decay and write-strength gates,
chunk kernels and gated norm with its output projection, in their
forward, recompute and backward (``_regions.py``)."""
from portbench.metrics import _regions


def read(run):
    t = _regions.tables(run)
    if t is None:
        return None
    rows = [row for path, row in t["paths"].items() if "kda" in path.split("/")]
    return sum(row["device_ms"] for row in rows) if rows else None
