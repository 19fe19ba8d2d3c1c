"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"hidden|intermediate|latent|state|projection|_dim$|_rank$|head"
                    r"|expansion|experts_per_tok|width|proj_dims")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    n = 24  # the most cells any later PR may bring
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).exists()
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert all(NAME.match(n) for n in names)
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


def test_every_cell_reports_enough():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert re.match(r"^[^\t\n]{1,200}$", m["layer"])
    for w in BENCH["workloads"]:
        ctx = harness.resolve(w["name"], REPO)
        got = {m["name"] for m in ctx.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert ctx.per_layer


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    ctx = harness.resolve(cell, REPO)
    assert ctx.driver_path.exists()
    for name, path in ctx.reader_paths.items():
        reader = harness.load_module(path, "pb_reader_" + name)
        assert callable(reader.read)
    for key in ("micro_batch", "accumulation", "pool"):
        assert key in ctx.traffic
    assert set(ctx.cell["limits"]) and ctx.cell["reference_steps"] >= 1


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", e2e[m["moves"]])) <= e2e[m["moves"]], m["name"]
    for cell in cells:
        moved = {m["moves"] for m in BENCH["per_layer"] if cell in m.get("workloads", cells)}
        assert moved and all(cell in e2e[n] for n in moved)
