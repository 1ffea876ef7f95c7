"""A copy of the benchmark at a size a CPU test can hold: the same files under
``bench/``, with a ``BENCHMARK.json`` of three small cells, one a driver,
added beside them as a later change would add a cell: by files alone."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:  # the program under test
    sys.path.insert(0, str(ROOT / "src"))

SLSH = {"m_out": 32, "L_out": 4, "m_in": 12, "L_in": 2, "alpha": 0.005, "k": 5, "val_lo": 20.0,
        "val_hi": 180.0, "c_max": 32, "c_in": 8, "h_max": 4, "p_max": 64, "c_comp": 1024,
        "build_chunk": 1024, "query_chunk": 16, "backend": "cuda", "payload": "f32"}
CELLS = {
    "tiny-batch": ("tiny-grid", "tiny-batch", {"driver": "batch", "call_windows": 48, "pool": 96,
                                               "profile_windows": 16, "host_windows": 8}),
    "tiny-stream": ("tiny-stream", "tiny-events", {"driver": "stream", "beds": 4, "start_fill_batches": [8, 3],
                                                   "live_block": 64, "check_ticks": 3, "profile_ticks": 1,
                                                   "host_ticks": 1}),
    "tiny-serve": ("tiny-grid", "tiny-icu", {"driver": "serve", "rate_windows_per_s": 1600.0,
                                             "tenants": [{"name": "bedside", "share": 0.3, "windows": [1, 1]},
                                                         {"name": "ward", "share": 0.7, "windows": [4, 16]}],
                                             "ladder": [8, 32], "pool": 96, "base_seed": 0,
                                             "profile_seconds": 0.2, "host_requests": 2}),
}
LIMITS = {"dist_gap": 1e-5, "idx_unmatched": 0, "comparisons_off": 0, "votes_off": 0, "tables_off": 0}


def make_root(tmp: Path) -> Path:
    """A checkout-like directory holding ``bench/`` and a small manifest."""
    root = Path(tmp) / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((ROOT / "bench" / "configs" / "ahe-grid40.json").read_text())
    grid = dict(base, name="tiny-grid", n=4096, slsh=SLSH, deployment={"kind": "grid", "nu": 2, "p": 2})
    stream = dict(grid, name="tiny-stream", deployment={"kind": "streaming", "nu": 2, "p": 2,
                                                        "node_capacity": 2560, "delta_cap": 32, "routed": True})
    for cfg in (grid, stream):
        (root / "bench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    manifest["configs"] = [{"name": c["name"], "source": "tests", "file": f"bench/configs/{c['name']}.json",
                            "reduced": ["n"], "why": "a CPU test"} for c in (grid, stream)]
    manifest["workloads"] = []
    for cell, (config, traffic, spec) in CELLS.items():
        (root / "bench" / "workloads" / f"{traffic}.json").write_text(json.dumps(spec))
        limits = {k: v for k, v in LIMITS.items() if spec["driver"] != "serve" or k in ("dist_gap", "idx_unmatched",
                                                                                       "tables_off")}
        if spec["driver"] == "serve":
            limits["unanswered"] = 0
        (root / "bench" / "limits" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
        manifest["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "test"})
    moves = {"tiny-batch": "queries_per_s", "tiny-stream": "event_p90_ms", "tiny-serve": "request_p95_ms"}
    for m in manifest["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [c for c, mv in moves.items() if mv == m["name"]]
    for m in manifest["per_layer"]:
        m["workloads"] = [c for c, mv in moves.items() if mv == m["moves"]]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def run(root: Path, cell: str, seed: int = 7, seconds: float = 0.05):
    """One untraced run of a small cell on the CPU -> (result, check lines, run)."""
    import time

    from bench import harness

    r = harness.Run(root, cell, seed, seconds, False, torch.device("cpu"), time.perf_counter())
    out, lines = harness.run_cell(r)
    return out, lines, r
