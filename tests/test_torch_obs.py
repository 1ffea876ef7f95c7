"""The port's observability layer against the JAX package's (DESIGN.md §12).

The same sequence of metric and span calls goes through ``repro.obs`` and
``repro_torch.obs``: the Prometheus text and the JSON snapshot must be
equal, and the Chrome trace documents equal but for their clock fields.
Then the port's instrumented paths: per-stage ``query.*`` and ``build.*``
spans inside ``index.query`` / ``index.build``, the query metrics on a
routed grid, and the streaming ingest span and counters.
"""
from __future__ import annotations

import json
import re

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import api
from repro_torch import obs as tobs
from repro_torch.core import distributed as tD
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.stream import StreamingMonitor


def _drive(obs_mod, registry, tracer):
    """One fixed sequence of metric and span calls."""
    registry.counter("dslsh_queries_total", "queries").labels(deployment="grid").inc(3)
    registry.counter("dslsh_queries_total", "queries").labels(deployment="single").inc()
    registry.gauge("dslsh_nodes_up", "live nodes").set(4)
    h = registry.histogram("dslsh_query_latency_seconds", "latency")
    for v in (2e-6, 5e-4, 5e-4, 0.2, 99.0):  # 99 s lands in +Inf
        h.observe(v)
    registry.histogram(
        "dslsh_routed_frac", "routed", buckets=obs_mod.log_buckets(0.01, 1.0, per_decade=8)
    ).observe(0.25)
    registry.histogram("dslsh_stage_latency_seconds", "stages").labels(stage="query.hash").observe(1e-3)
    with tracer.span("outer", deployment="single"):
        with tracer.span("inner", stage="hash"):
            pass


def test_exposition_and_trace_match_jax():
    reg_j, reg_t = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    tr_j, tr_t = jobs.Tracer(pid=7), tobs.Tracer(pid=7)
    _drive(jobs, reg_j, tr_j)
    _drive(tobs, reg_t, tr_t)
    assert reg_t.prometheus_text() == reg_j.prometheus_text()
    assert json.dumps(reg_t.snapshot()) == json.dumps(reg_j.snapshot())
    doc_j = json.loads(json.dumps(tr_j.to_chrome_trace()))
    doc_t = json.loads(json.dumps(tr_t.to_chrome_trace()))
    assert set(doc_t) == set(doc_j) == {"traceEvents", "displayTimeUnit"}
    assert doc_t["displayTimeUnit"] == doc_j["displayTimeUnit"] == "ms"
    for et, ej in zip(doc_t["traceEvents"], doc_j["traceEvents"], strict=True):
        assert set(et) == set(ej) == {"name", "ph", "ts", "dur", "pid", "tid", "args"}
        for f in ("name", "ph", "pid", "args"):
            assert et[f] == ej[f]
    inner, outer = doc_t["traceEvents"]
    assert outer["ts"] <= inner["ts"] and outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    assert tr_t.depth() == 0
    assert tmetrics.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS
    assert tmetrics.COUNT_BUCKETS == jobs.metrics.COUNT_BUCKETS
    assert tobs.log_buckets(1e-3, 5.0, 3) == jobs.log_buckets(1e-3, 5.0, 3)


def test_prometheus_text_golden_format():
    reg = tmetrics.MetricsRegistry()
    tr = ttrace.Tracer()
    _drive(tobs, reg, tr)
    text = reg.prometheus_text()
    sample_re = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
        r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?'
        r" -?[0-9.eE+\-]+(inf)?$"
    )
    for line in text.strip().splitlines():
        if line.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* ", line)
        else:
            assert sample_re.match(line), f"bad exposition line: {line!r}"
    counts = [int(m.group(2)) for m in re.finditer(r'dslsh_query_latency_seconds_bucket\{le="([^"]+)"\} (\d+)', text)]
    assert counts == sorted(counts) and counts[-1] == 5 and counts[-2] == 4
    assert 'dslsh_queries_total{deployment="grid"} 3' in text


def test_snapshot_roundtrip_kind_conflict_and_buckets():
    reg = tmetrics.MetricsRegistry()
    reg.counter("c_total", "help text").inc()
    reg.histogram("h_seconds").observe(1e-3)
    snap = json.loads(json.dumps(reg.snapshot()))
    assert snap["c_total"] == {"type": "counter", "help": "help text", "values": {"": 1.0}}
    assert snap["h_seconds"]["values"][""]["buckets"]["+Inf"] == 1
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c_total")
    with pytest.raises(ValueError, match="log_buckets"):
        tmetrics.log_buckets(lo=0.0)
    h = tmetrics.Histogram((1.0, 10.0, 100.0))
    for v in (1.0, 10.0, 100.0, 100.1):
        h.observe(v)
    assert h.counts == [1, 1, 1, 1] and h.cumulative() == [1, 2, 3, 4]
    assert h.quantile(0.5) == 10.0


def test_timed_section_activation_and_disabled_bundle(tmp_path):
    ob = tobs.Obs()
    assert tobs.get_active() is None
    with ob.activate():
        assert tobs.get_active() is ob
        with tobs.Obs().activate():
            assert tobs.get_active() is not ob
        with tobs.timed_section("unit.test") as sec:
            assert sec.elapsed_s >= 0.0
    assert tobs.get_active() is None
    assert [e["name"] for e in ob.tracer.events] == ["unit.test"]
    assert ob.snapshot()["dslsh_section_seconds"]["values"]['section="unit.test"']["count"] == 1
    with tobs.timed_section("nowhere") as sec:
        pass
    assert sec.obs is None
    off = tobs.Obs.disabled()
    assert not off.enabled and not off.tracing and off.span("x") is tobs.NULL_SPAN
    with pytest.raises(ValueError, match="disabled"):
        off.save_trace(str(tmp_path / "never.json"))


def _cfg(**kw):
    base = dict(m_out=12, L_out=8, m_in=8, L_in=4, alpha=0.02, k=5, val_lo=0.0, val_hi=1.0,
                c_max=32, c_in=8, h_max=4, p_max=64, build_chunk=128, query_chunk=16)
    base.update(kw)
    return api.make_config(**base)


def test_instrumented_query_and_build_record_stage_spans(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.random((300, 16), dtype=np.float32)
    q = rng.random((32, 16), dtype=np.float32)
    ob = tobs.Obs()
    idx = api.build(2, data, _cfg(build_chunk=64, build_mode="chunked"), api.single(), device="cpu", obs=ob)
    res = idx.query(q)
    assert torch.equal(res.knn_idx, idx.with_obs(None).query(q).knn_idx)
    names = {e["name"] for e in ob.tracer.events}
    assert {"index.build", "build.hash", "build.sort_runs", "build.merge", "build.heavy_inner",
            "index.query", "query.hash", "query.gather_work", "query.gather_select", "query.tail"} <= names
    for top_name, prefix in (("index.build", "build."), ("index.query", "query.")):
        top = next(e for e in ob.tracer.events if e["name"] == top_name)
        for e in ob.tracer.events:
            if e["name"].startswith(prefix):
                assert top["ts"] <= e["ts"] and e["ts"] + e["dur"] <= top["ts"] + top["dur"] + 1.0
    snap = ob.snapshot()
    assert snap["dslsh_queries_total"]["values"]['deployment="single"'] == 1.0
    assert snap["dslsh_query_latency_seconds"]["values"]['deployment="single"']["count"] == 1
    assert {'stage="query.hash"', 'stage="query.tail"'} <= set(snap["dslsh_stage_latency_seconds"]["values"])
    assert snap["dslsh_comparisons_total"]["values"][""] == float(res.comparisons.sum())
    gauges = snap["dslsh_index_bytes"]["values"]
    for name, b in idx.memory_report().per_cell.items():
        assert gauges[f'cell="0/0",component="{name}"'] == float(b)
    doc = json.loads(open(ob.save_trace(str(tmp_path / "trace.json"))).read())
    assert doc["traceEvents"] and all(e["ph"] == "X" for e in doc["traceEvents"])
    assert "# TYPE dslsh_query_latency_seconds histogram" in ob.prometheus()
    # the staged backend records one query.batch span, as the JAX package's
    ob2 = tobs.Obs()
    api.build(2, data, _cfg(backend="torch"), api.single(), device="cpu").with_obs(ob2).query(q)
    assert "query.batch" in {e["name"] for e in ob2.tracer.events}


def test_routed_grid_and_payload_feed_their_metrics():
    rng = np.random.default_rng(3)
    data = rng.random((256, 16), dtype=np.float32)
    q = rng.random((32, 16), dtype=np.float32)
    ob = tobs.Obs(trace=False)
    idx = api.build(5, data, _cfg(), api.grid(nu=2, p=2, replication=2), device="cpu", obs=ob)
    idx.query(q)
    snap = ob.snapshot()
    assert snap["dslsh_routed_frac"]["values"][""]["count"] == 1
    cells = snap["dslsh_routed_queries_per_cell_total"]["values"]
    assert set(cells) == {f'cell="{j}/{c}"' for j in range(2) for c in range(2)} and sum(cells.values()) > 0
    assert sum(snap["dslsh_replica_routed_queries_total"]["values"].values()) == sum(cells.values())
    ob2 = tobs.Obs(trace=False)
    single = api.build(2, data, _cfg(payload="f16", c_comp=64, c_rerank=64), api.single(), device="cpu", obs=ob2)
    res = single.query(q)
    assert ob2.snapshot()["dslsh_rerank_misses_total"]["values"][""] == float(res.rerank_miss_total)


def test_stream_monitor_records_ingest_and_predict():
    rng = np.random.default_rng(1)
    pts = rng.random((64, 8), dtype=np.float32)
    ob = tobs.Obs()
    mon = StreamingMonitor(
        0, pts, np.zeros(64, np.int8), _cfg(L_out=4, m_in=6, L_in=2, query_chunk=8), tD.Grid(nu=2, p=2),
        node_capacity=64, delta_cap=8, obs=ob, device="cpu",
    )
    before = tobs.retraces("stream_query")
    events = mon.replay(rng.random((40, 8), dtype=np.float32), np.zeros(40, np.int8), np.arange(40.0), batch_size=8)
    assert tobs.retraces("stream_query") == before  # steady state makes no program
    snap = ob.snapshot()
    assert snap["dslsh_stream_inserted_total"]["values"][""] == 40.0
    assert snap["dslsh_stream_compactions_total"]["values"][""] == float(sum(e.compacted for e in events)) > 0
    assert snap["dslsh_stream_predict_latency_seconds"]["values"][""]["count"] == 5
    names = [e["name"] for e in ob.tracer.events]
    assert names.count("stream.ingest") == 5 and names.count("stream.predict") == 5
    assert "query.gather_delta" in names  # the per-stage spans of the delta path
    clone = mon.core.clone()
    assert tobs.retraces("stream_query") == before  # an RCU clone shares the programs
    assert clone.n_index() == mon.n_index()
