"""The port's copies of the JAX package's framework-free modules: each is
its source with only the package name rewritten in import statements and
dotted strings (an adapted copy also differs by the lines its table names),
every ``dedloc_tpu_torch`` import inside the port resolves, and the DHT
record schemas equal the reference's field for field."""
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
    + [f"data/{n}.py" for n in ("__init__", "mlm", "streaming", "tokenizer",
                                "corpus", "prepare", "disk", "multicrop")]
    + ["finetune/metrics.py", "native/__init__.py", "join.py"]
    + [f"serving/{n}.py" for n in ("__init__", "admission", "host", "records",
                                   "router")]
    + ["utils/hub.py", "utils/jsonl.py", "roles/__init__.py"]
    + [f"simulator/{n}.py" for n in ("__init__", "engine", "network", "swarm",
                                     "scenarios")]
    + [f"twin/{n}.py" for n in ("__init__", "fit", "replay")]
)
# copies that extend their source: the source comes first, unchanged
EXTENDED = {"averaging/__init__.py": ("DeviceFlatPipeline", "FlatFetch",
                                      "named_device_leaves")}
# copies adapted to the port: (source line, the lines that replace it or
# None where it goes), each naming one line of the rewritten source exactly.
# The host roles hold no tensor on a device, so they resolve none: the JAX
# package's ``force_cpu_if_requested`` pins its platform and does nothing
# without a chip, the port's resolves the card and raises without one
_NO_DEVICE = (
    ("from dedloc_tpu_torch.roles.common import build_dht, force_cpu_if_requested",
     "from dedloc_tpu_torch.roles.common import build_dht"),
    ("    force_cpu_if_requested()", None),
)
# the JAX fleet pins every peer to the CPU so that none contends for the TPU
# chip; the port's trainers share the card, and only the host roles (the
# coordinator and the aux peers) start with CUDA hidden
_FLEET = (
    ("  pinned to CPU (DEDLOC_FORCE_CPU=1) so they never contend for the TPU chip;",
     "  the trainers on the card unless the caller sets DEDLOC_FORCE_CPU=1, the\n"
     "  coordinator and aux peers with CUDA hidden (they hold no device tensor);"),
    ('        env = dict(os.environ, DEDLOC_FORCE_CPU="1")',
     "        env = dict(os.environ)\n"
     '        if not module.endswith(".trainer"):\n'
     '            env["CUDA_VISIBLE_DEVICES"] = ""'),
)
ADAPTED = {"roles/coordinator.py": _NO_DEVICE, "roles/dht_node.py": _NO_DEVICE,
           "roles/gateway.py": _NO_DEVICE, "roles/fleet.py": _FLEET}

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


@pytest.mark.parametrize("rel", sorted(ADAPTED))
def test_adapted_copy_differs_from_its_source_only_by_its_table(rel):
    lines = _source(rel).split("\n")
    for old, new in ADAPTED[rel]:
        assert lines.count(old) == 1, old
        at = lines.index(old)
        lines[at:at + 1] = [] if new is None else new.split("\n")
    assert (REPO / "dedloc_tpu_torch" / rel).read_text() == "\n".join(lines)


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
                      if importlib.util.find_spec(name) is None})
    assert missing == []


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
