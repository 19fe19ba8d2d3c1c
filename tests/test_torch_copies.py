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
    + [f"core/{n}.py" for n in ("__init__", "auth", "serialization", "timeutils")]
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
                                      "named_device_leaves"),
            "telemetry/__init__.py": ("region",)}
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
# the JAX fleet's workers are TPU VMs (``gcloud compute tpus tpu-vm``); the
# port's are GCE instances with one H100 each, created as GPU instances
# must be (terminate on host maintenance), and the spec's defaults name them
_GCE_GPU = '''class GceGpuProvider(_CliProvider):
    """gcloud-backed provider on Compute Engine only: every worker
    (``kind`` "tpu", the fleet's accelerated worker) is an instance with
    one H100, the coordinator and aux peers plain VMs.

    A GPU instance cannot live-migrate, so it is created with
    ``--maintenance-policy=TERMINATE``; a spot worker is deleted when it is
    reclaimed and ``run_cloud_fleet`` recreates it by name. The machine
    type (``CloudFleetSpec.worker_accelerator``, "a3-highgpu-1g": one H100
    80GB, from Google Cloud's "GPU machine types" page) and the boot image
    (a Deep Learning VM image family that carries CUDA) are defaults an
    operator overrides."""

    def __init__(self, zone: str, dry_run: bool = False,
                 image_family: str = "common-cu128-ubuntu-2204-nvidia-570",
                 image_project: str = "deeplearning-platform-release",
                 boot_disk_gb: int = 200):
        super().__init__(dry_run)
        self.zone = zone
        self.image_family = image_family
        self.image_project = image_project
        self.boot_disk_gb = boot_disk_gb

    def create(self, name: str, kind: str, machine: str,
               startup_script: str, spot: bool) -> None:
        # the script goes through --metadata-from-file: an inline
        # --metadata value would need quoting the guest shell must NOT see
        # (argv exec adds no shell layer to strip it) and commas inside the
        # script would split metadata entries
        self.startup_scripts[name] = startup_script
        self._with_script_file(
            name, startup_script,
            lambda path: self._create_with_script(name, kind, machine, path,
                                                  spot),
        )
        if self.dry_run:
            self._dry_alive.append(name)

    def _create_with_script(self, name: str, kind: str, machine: str,
                            script_path: str, spot: bool) -> None:
        argv = [
            "gcloud", "compute", "instances", "create", name,
            f"--zone={self.zone}",
            f"--machine-type={machine}",
            f"--metadata-from-file=startup-script={script_path}",
        ]
        if kind == "tpu":
            argv += [
                "--maintenance-policy=TERMINATE",
                f"--image-family={self.image_family}",
                f"--image-project={self.image_project}",
                f"--boot-disk-size={self.boot_disk_gb}GB",
            ]
        if spot:
            argv += ["--provisioning-model=SPOT",
                     "--instance-termination-action=DELETE"]
        self._run(argv)

    def list_alive(self) -> List[str]:
        if self.dry_run:
            self.commands.append("gcloud compute instances list ...")
            return list(self._dry_alive)
        out = self._run([
            "gcloud", "compute", "instances", "list",
            f"--zones={self.zone}", "--format=value(name)",
        ])
        return [n for n in out.splitlines() if n]

    def delete(self, name: str, kind: str = "tpu") -> None:
        self._run(["gcloud", "compute", "instances", "delete", name,
                   f"--zone={self.zone}", "--quiet"])
'''
_CLOUD = (
    ("- ``Provider`` is the seam: ``GcloudTPUProvider`` shells out to ``gcloud``\n"
     "  (TPU VMs for workers, GCE for coordinator/aux; ``dry_run=True`` prints the",
     "- ``Provider`` is the seam: ``GceGpuProvider`` shells out to ``gcloud``\n"
     "  (GCE instances with one H100 for workers, plain VMs for coordinator/aux;\n"
     "  ``dry_run=True`` prints the"),
    ('    worker_accelerator: str = "v5litepod-1"  # g4dn-class: one chip per peer',
     '    worker_accelerator: str = "a3-highgpu-1g"  # one H100 per peer'),
    ('    zone: str = "us-central2-b"',
     '    zone: str = "us-central1-a"'),
    ('    repo_dir: str = "/opt/dedloc_tpu"',
     '    repo_dir: str = "/srv/dedloc"  # a checkout holding dedloc_tpu_torch'),
    (None, "class GcloudTPUProvider(_CliProvider):", "class AwsEc2Provider(_CliProvider):",
     _GCE_GPU + "\n\nclass AwsEc2Provider(_CliProvider):"),
)
# the port's trainer also runs the DeepSeek-V3 family, one expert-parallel
# rank per process, whose held experts the JAX package has no flag for; a
# port peer off a mesh always applies flat (the optimizer builds the flat
# twin of its own chain), so it has no --optimizer.flat_apply
_CONFIG = (
    ("    # fused flat optimizer apply (optim/flat.py + make_flat_apply_step):\n"
     "    # the averaged result crosses host->device as ONE buffer and the whole\n"
     "    # LAMB update runs as segment reductions over it, with the NaN guard\n"
     "    # fused in. Per-leaf guarded apply otherwise. Fleet-wide choice, like\n"
     "    # --averager.compression: peers should agree so replica params evolve\n"
     "    # identically (the flat math agrees with the per-leaf chain to float32\n"
     "    # reduction-order, ~1e-7 relative — see docs/perf.md round 6).\n"
     "    flat_apply: bool = True", None),
    ("    moe_aux_weight: float = 0.01",
     "    moe_aux_weight: float = 0.01\n"
     "    # the deepseek_v3 family (--training.model_size moonlight-16b-a3b):\n"
     "    # this rank holds routed experts [r * n, r * n + n), r the\n"
     "    # mesh_device_offset; 0 takes n = n_routed / mesh_expert_devices\n"
     "    moe_experts_held: int = 0\n"
     "    # ... cut to its first layers_held layers, the final norm and the head\n"
     "    # on the last of them (0: the whole depth)\n"
     "    layers_held: int = 0"),
)
ADAPTED = {"core/config.py": _CONFIG, "roles/coordinator.py": _NO_DEVICE, "roles/dht_node.py": _NO_DEVICE,
           "roles/gateway.py": _NO_DEVICE, "roles/fleet.py": _FLEET,
           "roles/cloud.py": _CLOUD}

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
    ours = (REPO / "dedloc_tpu_torch" / rel).read_text()
    source = _source(rel)
    if rel in EXTENDED:  # the source whole, then the port's additions
        ours = ours[:len(source)]
    assert ours == source


def _find(lines, block):
    """The one index where ``block`` (consecutive whole lines) starts."""
    at = [i for i in range(len(lines) - len(block) + 1)
          if lines[i:i + len(block)] == block]
    assert len(at) == 1, block
    return at[0]


def adapt(rel):
    """The rewritten source with its ``ADAPTED`` table applied. An entry
    (old, new) replaces the lines of ``old`` (new None: removes them); an
    entry (None, first, stop, new) replaces the lines from ``first`` up to
    the line ``stop``, that line included."""
    lines = _source(rel).split("\n")
    for entry in ADAPTED[rel]:
        if entry[0] is None:
            _, first, stop, new = entry
            at = _find(lines, [first])
            end = _find(lines, [stop]) + 1
            assert end > at, entry[:3]
        else:
            old, new = entry
            at = _find(lines, old.split("\n"))
            end = at + len(old.split("\n"))
        lines[at:end] = [] if new is None else new.split("\n")
    return "\n".join(lines)


@pytest.mark.parametrize("rel", sorted(ADAPTED))
def test_adapted_copy_differs_from_its_source_only_by_its_table(rel):
    assert (REPO / "dedloc_tpu_torch" / rel).read_text() == adapt(rel)


@pytest.mark.parametrize("rel", sorted(EXTENDED))
def test_extended_copy_starts_with_its_source(rel):
    ours = (REPO / "dedloc_tpu_torch" / rel).read_text()
    source = _source(rel)
    assert ours.startswith(source)
    extra = ours[len(source):]
    for name in EXTENDED[rel]:
        assert name in extra


# functions the port's tools copy verbatim from the repository's JAX tools:
# (the tool, the port's tool, the functions)
FUNCTION_COPIES = (
    ("tools/swav_probe.py", "dedloc_tpu_torch/tools/swav_probe.py",
     ("texture_image", "class_params", "generate", "_labeled_split")),
)


def _functions(path, names):
    text = (REPO / path).read_text()
    tree = ast.parse(text)
    found = {n.name: ast.get_source_segment(text, n) for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name in names}
    assert sorted(found) == sorted(names), path
    return found


@pytest.mark.parametrize("source,copy,names", FUNCTION_COPIES)
def test_tool_functions_are_verbatim_copies(source, copy, names):
    assert _functions(copy, names) == _functions(source, names)


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


# the port's own plain references (not copies): plain torch, so they import
# nothing of the port's kernels, nothing of the port and nothing of JAX; a
# relative import may name another plain reference alone
PLAIN_REFERENCES = ("testing/plain_deepseek_v3.py", "testing/plain_kimi_linear.py")


@pytest.mark.parametrize("rel", PLAIN_REFERENCES)
def test_plain_reference_imports_only_torch(rel):
    tree = ast.parse((REPO / "dedloc_tpu_torch" / rel).read_text())
    siblings = {r.split("/")[-1][:-3] for r in PLAIN_REFERENCES}
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            names = {node.module} if node.module else {a.name for a in node.names}
            assert names <= siblings, names
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
    assert roots <= {"__future__", "math", "typing", "torch"}, roots
