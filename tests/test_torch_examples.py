"""The port's streaming quickstart and ICU pipeline twins against the JAX
examples' code.

``examples/stream_quickstart.py`` runs as written (``runpy``), with its
beat generator handed 8 JAX-made records of 16,000 beats in place of
60,000 (the example indexes 8 records) so the file stays short; ``examples/torch_stream_quickstart.py``'s
``main`` gets the same beats and the JAX family from ``PRNGKey(1)``. Every
event (node, inserts, compactions, predictions, labels, comparisons,
overflow, index size, routed fraction), the rolling MCC and every printed
line but the latency one must be equal, on both of the port's backends.
The live record streams 2 nodes past their 64-slot delta segments, so the
nodes compact.
"""
from __future__ import annotations

import importlib.util
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import pipeline as jp
from repro.data import abp
from repro_torch import params

ROOT = Path(__file__).resolve().parents[1]
_JAX: dict = {}


def _beats():
    cfg = abp.ABPConfig(n_beats=16_000, episode_rate=1.0 / 2500.0)
    mapv, valid = abp.synth_dataset_beats(jax.random.PRNGKey(0), 8, cfg)
    return np.asarray(mapv), np.asarray(valid)


def _jax_example(monkeypatch, capsys):
    """The JAX example's globals and printed lines on the small beats."""
    if not _JAX:
        mapv, valid = _beats()
        with monkeypatch.context() as m:
            m.setattr(abp, "synth_dataset_beats", lambda *a, **k: (mapv, valid))
            g = runpy.run_path(str(ROOT / "examples" / "stream_quickstart.py"))
        _JAX.update(g=g, lines=capsys.readouterr().out.splitlines(), beats=(mapv, valid))
    return _JAX


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_stream_quickstart_twin_matches_jax_example(backend, monkeypatch, capsys):
    jx = _jax_example(monkeypatch, capsys)
    g = jx["g"]
    family = params.from_jax_params(*jp.make_family(jax.random.PRNGKey(1), 30, g["cfg"]), "cpu")
    spec = importlib.util.spec_from_file_location("_twin", ROOT / "examples" / "torch_stream_quickstart.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    out = twin.main(*jx["beats"], params=family, device="cpu", backend=backend)
    lines = capsys.readouterr().out.splitlines()
    ev_j, ev_t = g["events"], out["events"]
    assert len(ev_t) == len(ev_j) > 0
    assert out["compactions"] == sum(e.compacted for e in ev_j) > 0
    for a, b in zip(ev_t, ev_j):
        for f in ("t", "node", "inserted", "dropped", "compacted", "evicted", "preds", "labels", "comparisons",
                  "overflow", "n_index", "routed_frac"):
            assert getattr(a, f) == getattr(b, f), (f, b.t)
    assert out["rolling_mcc"] == pytest.approx(g["monitor"].mcc(), abs=1e-6)
    assert len(lines) == len(jx["lines"]) == 6
    for i, (a, b) in enumerate(zip(lines, jx["lines"])):
        if not b.startswith("prediction latency"):
            assert a == b, i


def test_icu_pipeline_twin_matches_jax_example(monkeypatch, capsys):
    """``examples/icu_pipeline.py`` as written, on 8 JAX-made records of
    16,000 beats (60,000 in the example), against the port's twin on the
    same beats with the JAX family: the same cluster line, the same three
    MCCs and the same median comparisons per processor."""
    mapv, valid = _beats()
    with monkeypatch.context() as m:
        m.setattr(abp, "synth_dataset_beats", lambda *a, **k: (mapv, valid))
        g = runpy.run_path(str(ROOT / "examples" / "icu_pipeline.py"))
    want = capsys.readouterr().out.splitlines()
    family = params.from_jax_params(*jp.make_family(jax.random.PRNGKey(1), 30, g["cfg"]), "cpu")
    spec = importlib.util.spec_from_file_location("_icu_twin", ROOT / "examples" / "torch_icu_pipeline.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    out = twin.main(mapv, valid, params=family, device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 5
    assert got == want
    np.testing.assert_array_equal(out["comparisons"].numpy(), np.asarray(g["res"].comparisons))
