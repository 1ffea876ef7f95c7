"""The whole of a run on the CPU at a small size: the harness finds a cell
added by files alone, the port agrees with the plain reference, and a
broken path or the lower-precision control comes out not correct."""
from __future__ import annotations

import pytest
import torch

from bench.tests import tiny

CELLS = list(tiny.CELLS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_added_by_files_alone_runs_and_is_correct(root, cell):
    out, lines, r = tiny.run(root, cell)
    assert out["correct"], lines
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert list(out)[-1] == "checks" and len(lines) == len(r.limits) + 1


def _answers(pipeline, transform):
    orig = pipeline.query_chunk

    def broken(*args, **kw):
        return transform(orig(*args, **kw))
    return broken


def _fault(name, monkeypatch):
    from repro_torch.core import distributed as D
    from repro_torch.core import pipeline
    from repro_torch.stream import shard

    if name == "state_unchanged":  # an ingest that returns the node as it was
        monkeypatch.setattr(shard.ShardedStream, "_insert", lambda self, node, xs, t: node)
    elif name == "half_batch":  # half of each query batch left out, its rows answered as the rest
        orig = pipeline.query_batch

        def half(index, data, queries, cfg, payload=None, delta=None):
            h = max(1, queries.shape[0] // 2)
            res = orig(index, data, queries[:h], cfg, payload, delta)
            take = torch.arange(queries.shape[0], device=queries.device) % h
            return pipeline.QueryResult(*(None if f is None else f[take] for f in res))
        monkeypatch.setattr(pipeline, "query_batch", half)
    elif name == "exchange_left_out":  # nodes past the first never reach the Reducer
        orig_cell = D.cell_query

        def lonely(index, data_local, node_offset, queries, cfg):
            res = orig_cell(index, data_local, node_offset, queries, cfg)
            if node_offset == 0:
                return res
            return D.CellResult(torch.full_like(res.knn_dist, float("inf")), torch.full_like(res.knn_idx, -1),
                                res.comparisons, res.compaction_overflow)
        monkeypatch.setattr(D, "cell_query", lonely)
        orig_node = shard.ShardedStream._node_query

        def lonely_node(self, node, node_id, queries, pk):
            kd, gidx, comps, over, routed = orig_node(self, node, node_id, queries, pk)
            if node_id:
                kd, gidx = torch.full_like(kd, float("inf")), torch.full_like(gidx, -1)
            return kd, gidx, comps, over, routed
        monkeypatch.setattr(shard.ShardedStream, "_node_query", lonely_node)
    elif name == "answer_altered":  # one neighbour of the first query changed where the tail writes it
        def alter(res):
            idx = res.knn_idx.clone()
            idx[0, 0] = idx[0, 0] + 1
            return res._replace(knn_idx=idx)
        monkeypatch.setattr(pipeline, "query_chunk", _answers(pipeline, alter))


FAULTS = [(cell, f) for cell in CELLS for f in ("half_batch", "exchange_left_out", "answer_altered")] + [
    ("tiny-stream", "state_unchanged")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_comes_out_not_correct(root, cell, fault, monkeypatch):
    _fault(fault, monkeypatch)
    out, lines, _ = tiny.run(root, cell)
    assert not out["correct"], lines


@pytest.mark.parametrize("cell", ["tiny-batch", "tiny-stream"])
def test_the_bfloat16_control_fails_a_number(root, cell):
    import time

    from bench import control, harness

    r = harness.Run(root, cell, 11, 0.0, False, torch.device("cpu"), time.perf_counter())
    nums = control.stream_numbers(r, 12) if cell == "tiny-stream" else control.grid_numbers(r)
    assert any(v > r.limits[k] for k, v in nums.items() if k in r.limits), nums


def test_the_reference_agrees_with_the_ports_torch_backend(tmp_path):
    import json

    root = tiny.make_root(tmp_path)
    path = root / "bench" / "configs" / "tiny-grid.json"
    cfg = json.loads(path.read_text())
    cfg["slsh"]["backend"] = "torch"
    path.write_text(json.dumps(cfg))
    out, lines, _ = tiny.run(root, "tiny-batch")
    assert out["correct"], lines
