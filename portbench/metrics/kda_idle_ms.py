"""Device idle ms a step charged to the ``kda`` region in any phase: the
gaps ended by an operation the KDA layers launched (``_regions.py``)."""
from portbench.metrics import _regions


def read(run):
    t = _regions.tables(run)
    if t is None:
        return None
    rows = [row for path, row in t["paths"].items() if "kda" in path.split("/")]
    return sum(row["idle_ms"] for row in rows) if rows else None
