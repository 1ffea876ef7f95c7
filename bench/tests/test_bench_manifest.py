"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units_keep_to_the_contract():
    assert set(MANIFEST) == KEYS["top"]
    assert MANIFEST["paths"] == ["bench"] and MANIFEST["command"] == ["python3", "bench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"]) and _text_ok(c["source"]) and _text_ok(c["why"])
        assert c["file"].startswith("bench/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4) and _text_ok(w["why"])
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            assert KEYS[kind] - {"workloads"} <= set(m) <= KEYS[kind] | {"workloads"}, m["name"]
            assert kind == "end_to_end" or m.get("workloads"), f"{m['name']} names the cells that report it"
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_bounds_and_the_set_up_metric():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    w = {x["name"]: x for x in MANIFEST["workloads"]}[cell]
    config = {c["name"]: c for c in MANIFEST["configs"]}[w["config"]]
    assert (ROOT / config["file"]).is_file()
    traffic = json.loads((ROOT / "bench" / "workloads" / f"{w['traffic']}.json").read_text())
    assert (ROOT / "bench" / "drivers" / f"{traffic['driver']}.py").is_file()
    assert json.loads((ROOT / "bench" / "limits" / f"{cell}.json").read_text())["limits"]
    reported = [m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in reported and len(reported) >= 2
    layer = [m for m in MANIFEST["per_layer"] if cell in m["workloads"]]
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        assert m["moves"] in reported, f"{m['name']} moves {m['moves']}, which {cell} does not report"


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]])
def test_every_metric_has_its_reader(metric):
    src = (ROOT / "bench" / "metrics" / f"{metric}.py").read_text()
    assert "def read(" in src


def test_a_full_check_fits_its_time_at_24_cells():
    seconds = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_in_bench_imports_jax_the_jax_package_or_benchmarks():
    for path in (ROOT / "bench").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path
