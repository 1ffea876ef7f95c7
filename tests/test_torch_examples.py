"""The port's streaming quickstart, ICU pipeline and LM twins against the
JAX examples' code.

``examples/stream_quickstart.py`` runs as written (``runpy``), with its
beat generator handed 8 JAX-made records of 16,000 beats in place of
60,000 (the example indexes 8 records) so the file stays short; ``examples/torch_stream_quickstart.py``'s
``main`` gets the same beats and the JAX family from ``PRNGKey(1)``. Every
event (node, inserts, compactions, predictions, labels, comparisons,
overflow, index size, routed fraction), the rolling MCC and every printed
line but the latency one must be equal, on both of the port's backends.
The live record streams 2 nodes past their 64-slot delta segments, so the
nodes compact. The LM twins (``torch_train_lm.py``, ``torch_serve_knn_lm.py``)
start from the JAX package's initial weights and train for a few steps on
the batches the JAX examples draw; their losses are held to the JAX train
step's.
"""
from __future__ import annotations

import importlib.util
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

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


# ------------------------------------------------------------ the LM twins
def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_losses(tcfg, opt_kw: dict, batches) -> tuple[dict, list[float]]:
    """The JAX package's initial params (numpy) for ``tcfg`` and the losses
    of its jitted train step over ``batches``."""
    import dataclasses

    import jax.numpy as jnp

    from repro.models import api as japi
    from repro.optim import adamw as jadamw
    from repro.train import loop as jloop

    jcfg = japi.ModelConfig(**dataclasses.asdict(tcfg))
    model = japi.build_model(jcfg)
    opt = jadamw.AdamWConfig(**opt_kw)
    p = model.init(jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, p)
    state = jadamw.init(p, opt)
    step = jax.jit(jloop.make_train_step(model, opt))
    losses = []
    for b in batches:
        p, state, m = step(p, state, {"tokens": jnp.asarray(b["tokens"])})
        losses.append(float(m["loss"]))
    return start, losses


# the two sides' bf16 matmuls round apart by an ulp here and there (see
# tests/test_torch_train.py); AdamW's early steps move every weight by about
# lr whatever its gradient's size, so a weight whose gradient is near zero
# may move the other way on the two sides, and at the serving demo's lr of
# 3e-3, where the loss falls by about 1.5 a step, three steps carry that to
# about 0.1 % of the loss: held to 0.5 %
LM_LOSS_RTOL = 5e-3


def test_torch_train_lm_twin_tracks_jax(capsys):
    """``examples/torch_train_lm.py`` from the JAX initial weights, 4 steps
    (200 in the example): each loss within ``LM_LOSS_RTOL`` of the JAX
    package's train step on the same batches and optimizer settings."""
    from repro.data.lm_data import TokenStream

    twin = _load("torch_train_lm")
    steps = 4
    opt_kw = dict(peak_lr=3e-4, warmup_steps=20, total_steps=steps, weight_decay=0.01)
    start, want = _jax_losses(twin.CFG_10M, opt_kw, TokenStream(twin.CFG_10M.vocab, seed=0).batches(steps, 4, 64))
    got = twin.main(steps=steps, params=start, ckpt_dir="", device="cpu")
    np.testing.assert_allclose(got, want, rtol=LM_LOSS_RTOL)
    out = capsys.readouterr().out
    assert "model: granite-10m" in out and "done. final loss:" in out


def test_torch_serve_knn_lm_twin_tracks_jax(capsys):
    """``examples/torch_serve_knn_lm.py`` from the JAX initial weights, 3
    training steps (120 in the example): the losses track the JAX package's
    train step; then the datastore and 6 requests served with lmbda 0 and
    0.3, the hook's output equal to ``knn_interpolate`` on the index's
    answer at every call."""
    from repro.data.lm_data import TokenStream
    from repro_torch.serve import engine

    twin = _load("torch_serve_knn_lm")
    steps = 3
    opt_kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=120)
    start, want = _jax_losses(twin.CFG, opt_kw, TokenStream(twin.CFG.vocab, seed=3).batches(steps, 8, 64))
    out = twin.main(params=start, steps=steps, device="cpu")
    np.testing.assert_allclose(out["losses"], want, rtol=LM_LOSS_RTOL)
    assert len(out["hook_calls"]) == 6 * 8
    assert all(len(g) == 8 for gens in out["tokens"].values() for g in gens)
    logits, mixed, hq = (torch.cat(t) for t in zip(*out["hook_calls"]))
    res = out["index"].query(hq)
    want_mixed = engine.knn_interpolate(logits, res.knn_idx, res.knn_dist, out["labels"], twin.CFG.vocab, 0.3)
    torch.testing.assert_close(mixed, want_mixed, rtol=1e-5, atol=1e-5)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("trained demo LM to loss=") and lines[1].startswith("SLSH datastore: 2016 hidden states")
    assert lines[-1] == "served 6 batched requests (latency-first engine)"
