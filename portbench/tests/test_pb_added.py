"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files plus new BENCHMARK.json entries are picked up with no existing
file of the benchmark edited."""
import hashlib
import json
import time
from pathlib import Path

from portbench import harness
from portbench.tests import tiny

READER = '''"""A test metric: the window's steps."""


def read(run):
    return float(run.steps)
'''


def _hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_picked_up(tmp_path):
    root = tiny.checkout(tmp_path)
    before = _hashes(root)
    tiny.add_cell(root, "tiny-albert", "albert-large", tiny.TINY_ALBERT,
                  {"generator": "mlm", "micro_batch": 2, "seq_length": 16,
                   "accumulation": 2, "pool": 6})
    (root / "portbench" / "metrics" / "steps_seen.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "model step",
                               "moves": "samples_per_s", "workloads": ["tiny-albert.cpu"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _hashes(root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    ctx = harness.resolve("tiny-albert.cpu", root)
    assert ctx.config["hidden_size"] == tiny.TINY_ALBERT["hidden_size"]
    assert ctx.traffic["seq_length"] == 16
    assert "steps_seen" in ctx.reader_paths
    reader = harness.load_module(ctx.reader_paths["steps_seen"], "pb_steps_seen")
    assert reader.read(type("Run", (), {"steps": 7})) == 7.0

    result = harness.run("tiny-albert.cpu", 2 ** 40 + 3, 0.5, False,
                         time.perf_counter(), device="cpu", root=root)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"samples_per_s", "peak_mem_gib", "setup_s"}
    assert list(result)[-1] == "compared"
    assert set(result["compared"]) == set(tiny.LIMITS)
