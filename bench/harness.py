"""One run of one cell: find its files by name, drive it, read its metrics,
judge it and print the result.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``), a traffic
mix (``bench/workloads/<traffic>.json``, whose ``driver`` names
``bench/drivers/<driver>.py``) and, by the cell's own name, its limits
(``bench/limits/<cell>.json``). Every metric, end to end or per layer, is
read by ``bench/metrics/<metric>.py`` from what the driver recorded. So a
cell, a configuration or a metric is added by adding files.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

from bench import check

# top-level module names that no run may have loaded once its window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def use_checkout_caches(root: Path) -> None:
    """Point every kernel and build cache a run could write at fixed
    directories inside the checkout (the port itself builds its kernels
    under ``build/repro_torch_kernels``)."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names, compared whole, among ``names`` (the
    loaded modules by default)."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))


def load_module(path: Path, name: str):
    """Import a file of ``bench/`` by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at least
    ``q`` percent of the values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    rank = max(1, -(-len(vals) * q // 100))
    return float(vals[int(rank) - 1])


class Run:
    """Everything one run of one cell reads and records."""

    def __init__(self, root: Path, cell: str, seed: int, seconds: float, trace: bool,
                 device: torch.device, t_start: float):
        self.root = Path(root)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if cell not in cells:
            raise SystemExit(f"no workload {cell!r} in BENCHMARK.json; one of {sorted(cells)}")
        self.cell = cells[cell]
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config = json.loads((self.root / configs[self.cell["config"]]["file"]).read_text())
        bench = self.root / "bench"
        self.traffic = json.loads((bench / "workloads" / f"{self.cell['traffic']}.json").read_text())
        self.limits = json.loads((bench / "limits" / f"{cell}.json").read_text())["limits"]
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), bool(trace), device
        self.t_start = t_start
        self.setup_s: float | None = None
        self.memory_peak_bytes: int | None = None
        self.attempted = 0
        self.failed = 0
        self.record: dict = {}  # what the driver saw, for the metric readers
        self.numbers: dict = {}  # what the reference comparison found
        self.breakdown: dict | None = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        """Set-up ends here: the next operation is the first timed one."""
        self.sync()
        self.t_window = time.perf_counter()
        self.setup_s = self.t_window - self.t_start

    def window_done(self) -> None:
        """The measured window is over: read the peak before the reference."""
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def metrics(self) -> dict:
        """The cell's end-to-end metrics (untraced run) or per-layer metrics
        (traced run), each read by its own reader; a reader that finds
        nothing leaves its metric out."""
        name = self.cell["name"]
        reported = {m["name"] for m in self.manifest["end_to_end"] if name in m.get("workloads", [name])}
        if self.trace:
            wanted = [m for m in self.manifest["per_layer"] if name in m["workloads"]]
        else:
            wanted = [m for m in self.manifest["end_to_end"] if m["name"] in reported]
        out = {}
        for m in wanted:
            reader = load_module(self.root / "bench" / "metrics" / f"{m['name']}.py", f"bench_metric_{m['name']}")
            value = reader.read(self)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out

    def result(self) -> tuple[dict, list[str]]:
        """The result line's object and the check lines for standard error."""
        correct, checks = check.verdict(self.numbers, self.limits)
        device = {"platform": "gpu" if self.device.type == "cuda" else self.device.type,
                  "kind": torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu",
                  "count": int(self.cell.get("chips", 1)),
                  "memory_peak_bytes": self.memory_peak_bytes}
        prof = self.record.get("profile")
        if self.trace and prof is not None:
            device["busy_s"] = prof["busy_s"]
            device["window_s"] = prof["window_s"]
        out = {"correct": correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics(), "device": device}
        if self.trace and self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = checks
        lines = [f"phases: set-up {self.setup_s:.1f} s, window to result {time.perf_counter() - self.t_window:.1f} s"]
        lines += [f"check {name}: {c['value']} (limit {c['limit']})" for name, c in checks.items()]
        return out, lines


def run_cell(run: Run) -> tuple[dict, list[str]]:
    """Drive ``run``'s cell with its driver and return its result."""
    driver = load_module(run.root / "bench" / "drivers" / f"{run.traffic['driver']}.py",
                         f"bench_driver_{run.traffic['driver']}")
    driver.run(run)
    return run.result()
