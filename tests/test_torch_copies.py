"""The port's copies of the JAX package's framework-free modules: each is
its source with only the package name rewritten in import statements and
dotted strings, every ``dedloc_tpu_torch`` import inside the port resolves,
and the DHT record schemas equal the reference's field for field."""
import ast
import importlib
import importlib.util
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

# (module path under both packages) for each verbatim copy
COPIES = (
    [f"dht/{n}.py" for n in ("__init__", "crypto", "dht", "nat", "node", "protocol",
                             "routing", "storage", "transport", "validation")]
    + [f"averaging/{n}.py" for n in ("allreduce", "averager", "matchmaking",
                                     "partition", "planwire", "topology")]
    + [f"checkpointing/{n}.py" for n in ("__init__", "catalog", "fetcher",
                                         "manifest", "store")]
    + [f"collaborative/{n}.py" for n in ("__init__", "error_feedback", "metrics",
                                         "progress")]
    + [f"core/{n}.py" for n in ("__init__", "auth", "serialization", "timeutils",
                                "config")]
    + [f"telemetry/{n}.py" for n in ("__init__", "events", "health", "ledger",
                                     "links", "registry", "watch")]
    + ["testing/__init__.py", "testing/faults.py"]
    + [f"utils/{n}.py" for n in ("aio", "logging", "stats", "checkpoint")]
    + ["data/__init__.py", "data/mlm.py", "data/streaming.py",
       "native/__init__.py", "serving/records.py", "join.py"]
)
# copies that extend their source: the source comes first, unchanged
EXTENDED = {"averaging/__init__.py": ("DeviceFlatPipeline", "FlatFetch",
                                      "named_device_leaves")}
# imports of modules a later slice brings, each lazily inside a function
# (``telemetry/watch.py``): the digital twin replays on the simulator, which
# reaches the coordinator role and the serving plane's host and router
ALLOWED_MISSING = {"dedloc_tpu_torch.twin.fit", "dedloc_tpu_torch.twin.replay"}

_DOTTED = re.compile(r"\bdedloc_tpu(?=\.| import\b)")


def rewrite(text: str, rel: str) -> str:
    """``dedloc_tpu.`` -> ``dedloc_tpu_torch.`` in import statements and
    dotted strings. The logging copy also names its own root logger, so the
    port's module loggers (``dedloc_tpu_torch.*``) sit under it."""
    text = _DOTTED.sub("dedloc_tpu_torch", text)
    if rel == "utils/logging.py":
        text = text.replace('"dedloc_tpu"', '"dedloc_tpu_torch"')
    return text


def _source(rel):
    return rewrite((REPO / "dedloc_tpu" / rel).read_text(), rel)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_source(rel):
    assert (REPO / "dedloc_tpu_torch" / rel).read_text() == _source(rel)


@pytest.mark.parametrize("rel", sorted(EXTENDED))
def test_extended_copy_starts_with_its_source(rel):
    ours = (REPO / "dedloc_tpu_torch" / rel).read_text()
    source = _source(rel)
    assert ours.startswith(source)
    extra = ours[len(source):]
    for name in EXTENDED[rel]:
        assert name in extra


def _port_imports():
    for path in sorted((REPO / "dedloc_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
                if node.module == "dedloc_tpu_torch":
                    names = [f"dedloc_tpu_torch.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            for name in names:
                if name.split(".")[0] == "dedloc_tpu_torch":
                    yield path.relative_to(REPO), name


def test_every_dotted_port_import_resolves():
    missing = sorted({(str(p), name) for p, name in _port_imports()
                      if name not in ALLOWED_MISSING
                      and importlib.util.find_spec(name) is None})
    assert missing == []
    found = {name for _p, name in _port_imports()}
    assert ALLOWED_MISSING <= found, "an allow-listed import is gone: drop it"


@pytest.mark.parametrize("module,model", [
    ("collaborative.metrics", "LocalMetrics"),
    ("collaborative.metrics", "MetricSchema"),
    ("telemetry.ledger", "ContributionClaim"),
    ("telemetry.ledger", "RoundReceipt"),
    ("checkpointing.catalog", "CheckpointAnnouncement"),
    ("averaging.planwire", "PlanRecord"),
])
def test_record_schemas_equal_the_reference(module, model):
    ours = getattr(importlib.import_module(f"dedloc_tpu_torch.{module}"), model)
    theirs = getattr(importlib.import_module(f"dedloc_tpu.{module}"), model)
    assert ours.model_json_schema() == theirs.model_json_schema()
