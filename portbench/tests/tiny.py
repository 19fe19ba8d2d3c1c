"""A checkout in a temporary directory with tiny cells beside the real
ones, for CPU runs of the harness: the benchmark's files copied, the
program linked, tiny configurations, traffic and cells added as new files
with their entries in ``BENCHMARK.json``."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_ALBERT = {
    "vocab_size": 512, "embedding_size": 16, "hidden_size": 32,
    "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
    "max_position_embeddings": 64, "type_vocab_size": 2,
    "initializer_range": 0.02, "layer_norm_eps": 1e-12,
}
TINY_SWAV = {
    "stage_sizes": [1, 1, 1, 1], "width": 8, "proj_dims": [256, 64, 16],
    "num_prototypes": [32], "crop_sizes": [32, 16], "crop_counts": [2, 2],
    "num_crops": 4, "queue_length": 16,
}
LIMITS = {"loss_gap": 0.05, "sum_gap": 0.2, "grad_gap": 0.2, "change_gap": 0.2,
          "change_diff": 0.5}


def checkout(tmp: Path) -> Path:
    """A copy of the benchmark with the program linked beside it."""
    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "dedloc_tpu_torch").symlink_to(REPO / "dedloc_tpu_torch")
    return root


def add_cell(root: Path, name: str, base_config: str, config_over: dict,
             traffic: dict, cell_over: dict = None,
             end_to_end=("samples_per_s",)) -> None:
    """Add config ``<name>``, traffic ``<name>`` and cell ``<name>.cpu`` as
    new files plus new entries of ``BENCHMARK.json``, the cell named in the
    ``workloads`` of the end-to-end metrics ``end_to_end``."""
    base = root / "portbench"
    config = json.loads((base / "configs" / f"{base_config}.json").read_text())
    config.update(config_over, name=name, reduced=sorted(config_over))
    (base / "configs" / f"{name}.json").write_text(json.dumps(config))
    (base / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    cell = {"config": name, "traffic": name, "chips": 1, "why": "a CPU test cell",
            "program": {"remat_policy": "fused_ln", "attention_impl": "flash"},
            "reference_steps": 3, "warm_steps": 3, "profile_steps": 1,
            "limits": dict(LIMITS)}
    cell.update(cell_over or {})
    (base / "workloads" / f"{name}.cpu.json").write_text(json.dumps(cell))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test", "reduced": [],
                             "file": f"portbench/configs/{name}.json", "why": "test"})
    bench["workloads"].append({"name": f"{name}.cpu", "config": name,
                               "traffic": name, "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in end_to_end:
            m["workloads"].append(f"{name}.cpu")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def tiny_root(tmp: Path) -> Path:
    root = checkout(tmp)
    add_cell(root, "tiny-albert", "albert-large", TINY_ALBERT,
             {"generator": "mlm", "micro_batch": 4, "seq_length": 32,
              "accumulation": 2, "pool": 6})
    add_cell(root, "tiny-swav", "swav-resnet50", TINY_SWAV,
             {"generator": "multicrop", "micro_batch": 4, "accumulation": 1,
              "pool": 3}, {"program": {}})
    return root


def tiny_swav_fp32_root(tmp: Path) -> Path:
    """The tiny SwAV cell with its trunk in float32: at a width of 8 and 4
    images the bf16 trunk's rounding swamps every number compared, so the
    CPU cell that checks the harness's judgement runs the trunk in fp32,
    with limits at float32's noise."""
    root = checkout(tmp)
    add_cell(root, "tiny-swav32", "swav-resnet50", TINY_SWAV,
             {"generator": "multicrop", "micro_batch": 4, "accumulation": 1,
              "pool": 3},
             {"program": {"trunk_dtype": "float32"},
              "limits": {"loss_gap": 1e-3, "sum_gap": 1e-3, "grad_gap": 1e-3,
                         "change_gap": 1e-3, "change_diff": 1e-3}})
    return root


def readings(root: Path, cell: str, seed: int, **reference_kw):
    """(the program's numbers, the broken reference's, the cell's limits) of
    one seed, taken as a run takes them, on the CPU: the reference with
    ``reference_kw`` put in the program's place."""
    from portbench import harness
    from portbench.reference import compare

    ctx = harness.resolve(cell, root)
    ctx.seed, ctx.device = seed, "cpu"
    driver = harness.load_module(ctx.driver_path, "pb_tiny_driver")
    program, got = harness.first_steps(ctx, driver)
    program.close()
    numbers, ref, _s = harness.against_reference(ctx, driver, got)
    broken = driver.reference(ctx, ctx.cell["reference_steps"], **reference_kw)
    return numbers, compare.gaps(broken, ref), ctx.cell["limits"]
