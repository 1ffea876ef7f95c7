"""The traffic generators and the metric arithmetic of the benchmark."""
from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench import harness, inputs, roofline, trace
from bench.tests import tiny  # noqa: F401  (puts the port on the path)

ROOT = Path(__file__).resolve().parents[2]


def _serve_driver():
    return harness.load_module(ROOT / "bench" / "drivers" / "serve.py", "bench_test_serve")


def test_the_same_seed_gives_the_same_windows_and_family():
    spec = json.loads((ROOT / "bench" / "configs" / "ahe-grid40.json").read_text())
    a = inputs.windows(spec["windows"], 300, inputs.generator(2**31 + 9, "data", "cpu"))
    b = inputs.windows(spec["windows"], 300, inputs.generator(2**31 + 9, "data", "cpu"))
    c = inputs.windows(spec["windows"], 300, inputs.generator(2**31 + 9, "queries", "cpu"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and not torch.equal(a[0], c[0])
    pts, labels = a
    assert pts.dtype == torch.float32 and pts.shape == (300, 30)
    assert float(pts.min()) >= 20.0 and float(pts.max()) <= 180.0
    assert torch.equal(labels, (pts[:, -1] < 60.0).to(torch.int8))
    f1 = inputs.family(spec["slsh"], 30, inputs.generator(5, "family", "cpu"))
    f2 = inputs.family(spec["slsh"], 30, inputs.generator(5, "family", "cpu"))
    assert all(torch.equal(f1[i][k], f2[i][k]) for i in range(2) for k in f1[i])
    assert f1[0]["dims"].shape == (16, 32) and int(f1[0]["dims"].max()) < 30
    assert f1[1]["proj"].shape == (4, 30, 12)


@pytest.mark.parametrize("seconds", [1.0, 30.0])
def test_every_seed_offers_the_same_requests_in_its_own_order(seconds):
    serve = _serve_driver()
    tr = json.loads((ROOT / "bench" / "workloads" / "icu-open.json").read_text())
    a = serve.arrivals(tr, seconds, 1, "window")
    b = serve.arrivals(tr, seconds, 2**33 + 1, "window")
    assert sorted((t, k) for _, t, k in a) == sorted((t, k) for _, t, k in b)
    assert [x[0] for x in a] != [x[0] for x in b] or len(a) < 3
    due = [x[0] for x in a]
    assert due == sorted(due) and due[0] == 0.0 and due[-1] < seconds
    windows = sum(k for _, _, k in a)
    assert abs(windows / seconds - tr["rate_windows_per_s"]) < 0.25 * tr["rate_windows_per_s"]
    for name, k in ((t, k) for _, t, k in a):
        lo, hi = {x["name"]: x["windows"] for x in tr["tenants"]}[name]
        assert lo <= k <= hi


def test_nearest_rank_percentile():
    assert harness.percentile([5, 1, 3, 2, 4], 50) == 3
    assert harness.percentile(range(1, 101), 95) == 95
    assert harness.percentile(range(1, 101), 90) == 90
    assert harness.percentile([7], 95) == 7


def test_the_tail_work_and_bound():
    nbytes, ops = roofline.tail_work(comparisons=1000, queries=10, cand_width=1024, d=30, k=10)
    assert nbytes == 4 * (1000 * 30 + 10 * (30 + 1024 + 20)) and ops == 3 * 1000 * 30
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)


def _run(record, trace_on=False):
    return SimpleNamespace(record=record, setup_s=12.5, trace=trace_on)


@pytest.mark.parametrize("name,record,want", [
    ("queries_per_s", {"calls": [(1000, 2.0), (1000, 3.0)]}, 400.0),
    ("event_p90_ms", {"ticks": [(i / 1000, 0, 16, False) for i in range(1, 11)]}, 9.0),
    ("predict_ms.stream", {"ticks": [(0.3, 0.2, 16, False), (0.5, 0.1, 16, False), (0.2, 0.15, 16, False)]}, 150.0),
    ("ingest_ms.stream", {"ticks": [(0.3, 0.2, 16, False), (0.5, 0.1, 16, False), (0.2, 0.15, 16, False)]}, 100.0),
    ("request_p95_ms", {"latency_s": [0.001 * i for i in range(1, 21)]}, 19.0),
    ("request_p95_ms", {"latency_s": [0.001] * 18 + [float("inf")] * 2}, 1e9),
    ("pump_ms.serve", {"pump_s": [0.1, 0.3, 0.2]}, 200.0),
    ("generator_lag_ms.serve", {"lag_s": [0.001 * i for i in range(1, 21)]}, 19.0),
    ("microbatch_fill.serve", {"served_rows": 300.0, "pad_rows": 100.0}, 75.0),
    ("comparisons_per_query.batch", {"comparisons": 5000, "queries": 10}, 500.0),
    ("launches_per_query.batch", {"profile": {"n_ops": 900}, "profile_queries": 9}, 100.0),
    ("device_idle.batch", {"profile": {"busy_s": 0.25, "window_s": 1.0}}, 75.0),
    ("query_tail_roofline.batch", {"tail_bound_s": 1e-6, "profile": {"ops": {
        "void query_tail_kernel<64>(TailArgs)": (4e-6, 2), "other": (1.0, 5)}}}, 25.0),
    ("setup_s", {}, 12.5),
])
def test_metric_readers(name, record, want):
    reader = harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py", f"bench_test_{name}")
    assert reader.read(_run(record)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["queries_per_s", "query_tail_roofline.batch", "device_idle.stream", "pump_ms.serve",
                                  "generator_lag_ms.serve"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    reader = harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py", f"bench_test_none_{name}")
    assert reader.read(_run({})) is None


def test_kernel_names_and_top_ops():
    assert trace.kernel_name("void query_tail_kernel<8, true>(TailArgs)") == "query_tail_kernel"
    summary = {"ops": {"a": (0.5, 1), "b": (1.5, 3), "c": (0.1, 9)}}
    assert trace.top_ops(summary, 2) == [["b", 1.5], ["a", 0.5]]
    assert trace.kernel_seconds(summary, "b") == (1.5, 3)
    assert trace.idle_percent(None) is None


def test_a_run_without_a_card_stops_before_any_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this sandbox test is about a machine without a card")
    run = harness.load_module(ROOT / "bench" / "run.py", "bench_test_run")
    assert run.main(["--workload", "grid40-batch1000", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.api", "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "benchmarks"]) == ["benchmarks", "jax", "repro"]


def test_shuffled_is_a_permutation_fixed_by_the_seed():
    v = np.arange(50)
    a, b = inputs.shuffled(v, 3, "x"), inputs.shuffled(v, 3, "x")
    assert np.array_equal(a, b) and sorted(a) == list(v) and not np.array_equal(a, inputs.shuffled(v, 4, "x"))


def test_live_windows_are_drawn_as_asked_and_fixed_by_the_seed():
    spec = json.loads((ROOT / "bench" / "configs" / "ahe-stream40.json").read_text())["windows"]
    a, b = inputs.LiveWindows(spec, 2**33 + 5, 64, "cpu"), inputs.LiveWindows(spec, 2**33 + 5, 64, "cpu")
    far = a(64 * 40 + 16, 64 * 40 + 32)  # drawn far ahead: the blocks before it come too
    near = b(16, 32)
    assert len(a.blocks) == 41 and len(b.blocks) == 1
    assert torch.equal(a(16, 32)[0], near[0]) and torch.equal(b(64 * 40 + 16, 64 * 40 + 32)[0], far[0])
    assert not torch.equal(far[0], near[0]) and far[0].shape == (16, 30)
    assert np.array_equal(far[2], far[1].numpy())
    with pytest.raises(ValueError):
        a(60, 70)
