"""The port's serving layer against the JAX package's on the same inputs:
``knn_interpolate``, the kNN-LM hook over a ``grid(nu=2, p=4)`` DSLSH
datastore of hidden states (the shape of ``examples/serve_knn_lm.py``
steps 2-3) in its handle form, its deprecated positional form and with
``degrade`` levels on a routed index (the cap and its counter),
``ServeEngine``'s batched greedy tokens, its deadlines and its ``obs``
span and metrics, and the serving launcher.

The datastore keys are the JAX model's hidden states as numpy arrays, and
the hash family is the JAX package's, carried across, so both indexes hold
the same buckets. Neighbour distances agree within rtol = atol = 1e-5 (sums
over d in another order) and indices tie-aware
(``core.topk.topk_mismatch``); the hook's log-probabilities within 1e-5,
since both sides compute the same float32 softmax mixture and may add a
token's neighbour weights in another order. The engines run the same
weights (carried with ``model_params_from_numpy``) and must produce the same
greedy tokens.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import dslsh as jdslsh
from repro.core import pipeline as jp
from repro.data import lm_data as jlm
from repro.models import api as japi
from repro.models import dense as jdense
from repro.serve import engine as jengine
from repro_torch import api as tdslsh
from repro_torch import configs as tconfigs
from repro_torch import params as tparams
from repro_torch.core import topk as ttopk
from repro_torch.kernels import _build
from repro_torch.launch import serve as tlaunch
from repro_torch.models import api as tapi
from repro_torch.obs import clock
from repro_torch.serve import engine as tengine

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    _build.reset_launches()
    yield
    assert _build.LAUNCHES == {}, "a kernel launched on the CPU"


# ------------------------------------------------------------ interpolation
def test_knn_interpolate_matches_jax():
    rng = np.random.default_rng(0)
    vocab, b, k, n = 32, 4, 6, 50
    logits = rng.standard_normal((b, vocab)).astype(np.float32) * 3
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    dist = np.sort(rng.random((b, k)).astype(np.float32) * 5, axis=1)
    idx[1, 3:], dist[1, 3:] = -1, np.inf  # a short row
    idx[2], dist[2] = -1, np.inf  # no neighbour: the base distribution
    labels = rng.integers(0, vocab, n).astype(np.int32)
    labels[idx[0, 0]] = labels[idx[0, 1]]  # two neighbours vote one token
    for lmbda, temp in ((0.25, 1.0), (0.5, 0.3), (0.0, 1.0)):
        got = tengine.knn_interpolate(*(torch.tensor(a) for a in (logits, idx, dist, labels)), vocab, lmbda, temp)
        want = jengine.knn_interpolate(*(jnp.asarray(a) for a in (logits, idx, dist, labels)), vocab, lmbda, temp)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    base = torch.log_softmax(torch.tensor(logits[2]), -1)
    np.testing.assert_allclose(_np(got[2]), _np(base), **TOL)


# ------------------------------------------------------------ the kNN-LM hook
FAMILY = dict(m_out=24, L_out=8, m_in=12, L_in=4, alpha=0.02)  # examples/serve_knn_lm.py
BUDGET = dict(k=8, c_max=64, c_in=16, h_max=4, p_max=128)


@pytest.fixture(scope="module")
def datastore():
    """Hidden states of the JAX granite-smoke model over a TokenStream batch
    (keys at positions t, labels the tokens at t + 1), a grid(nu=2, p=4)
    JAX index over them and its hash family, and query hidden states."""
    cfg = jconfigs.get("granite-8b", smoke=True)
    params = japi.build_model(cfg).init(jax.random.PRNGKey(0))
    stream = jlm.TokenStream(cfg.vocab, seed=3)
    toks = jnp.asarray(stream.batch(16, 33))

    def hidden(t):
        x, _ = jdense._embed_inputs(cfg, params, {"tokens": t})
        return jdense._run_layers(cfg, params, x, jnp.arange(t.shape[1]), "none")

    h = hidden(toks)
    keys = np.asarray(h[:, :-1].reshape(-1, cfg.d_model), np.float32)
    labels = np.asarray(toks[:, 1:].reshape(-1), np.int32)
    deploy = jdslsh.grid(nu=2, p=4)
    fam = dict(FAMILY, val_lo=float(keys.min()), val_hi=float(keys.max()))
    cfg_s = jdslsh.make_config(jdslsh.FamilyConfig(**fam), jdslsh.BudgetConfig(**BUDGET))
    pts, labs, _ = jdslsh.pad_to_multiple(keys, labels, deploy.cells)
    index = jdslsh.build(jax.random.PRNGKey(9), jnp.asarray(pts), cfg_s, deploy)
    queries = np.asarray(hidden(jnp.asarray(stream.batch(5, 12)))[:, -1], np.float32)
    return dict(cfg=cfg, fam=fam, pts=pts, labs=labs, index=index, queries=queries,
                family=jp.make_family(jax.random.PRNGKey(9), pts.shape[1], cfg_s))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_knn_lm_hook_matches_jax(datastore, backend):
    ds = datastore
    vocab = ds["cfg"].vocab
    cfg = tdslsh.make_config(tdslsh.FamilyConfig(**ds["fam"]), tdslsh.BudgetConfig(**BUDGET), backend=backend)
    index = tdslsh.build(0, ds["pts"], cfg, tdslsh.grid(nu=2, p=4), device="cpu", params=ds["family"])
    logits = np.random.default_rng(1).standard_normal((5, vocab)).astype(np.float32)
    for lmbda in (0.3, 0.0):
        thook = tengine.make_knn_lm_hook(index, ds["labs"], hidden_fn=lambda c: c, vocab=vocab, lmbda=lmbda)
        jhook = jengine.make_knn_lm_hook(ds["index"], jnp.asarray(ds["labs"]), hidden_fn=lambda c: c,
                                         vocab=vocab, lmbda=lmbda)
        assert thook.accepts_budget
        got = thook(torch.tensor(logits), torch.tensor(ds["queries"]))
        want = jhook(jnp.asarray(logits), jnp.asarray(ds["queries"]))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the retrieval under the hook: the same neighbours
    tres, jres = index.query(ds["queries"]), ds["index"].query(jnp.asarray(ds["queries"]))
    assert int(tres.overflow_cells) == int(jres.overflow_cells)
    assert bool((tres.knn_idx >= 0).any())
    pts, qs = torch.tensor(ds["pts"]), torch.tensor(ds["queries"])
    why = ttopk.topk_mismatch(
        tres.knn_dist, tres.knn_idx, torch.tensor(np.asarray(jres.knn_dist)), torch.tensor(np.asarray(jres.knn_idx)),
        lambda rows, idx: (pts[idx.long()] - qs[rows]).abs().sum(-1), rtol=1e-5, atol=1e-5,
    )
    assert why is None, why


def test_knn_lm_hook_refuses_what_is_not_ported(datastore):
    """What the JAX package's hook refuses, with its messages: ``degrade``
    on an unrouted index, ``plan`` beside a handle, no labels."""
    ds = datastore
    cfg = tdslsh.make_config(tdslsh.FamilyConfig(**ds["fam"]), tdslsh.BudgetConfig(**BUDGET))
    index = tdslsh.build(0, ds["pts"], cfg, tdslsh.grid(nu=2, p=4), device="cpu", params=ds["family"])
    kw = dict(hidden_fn=lambda c: c, vocab=ds["cfg"].vocab)
    with pytest.raises(ValueError, match="degrade levels require a routed deployment"):
        tengine.make_knn_lm_hook(index, ds["labs"], degrade=((0.01, 2),), **kw)
    with pytest.raises(ValueError, match="routing lives on the handle"):
        tengine.make_knn_lm_hook(index, ds["labs"], plan=object(), **kw)
    with pytest.raises(ValueError, match="next-token labels"):
        tengine.make_knn_lm_hook(index, **kw)


def test_make_knn_lm_hook_legacy_signature_warns_and_matches(datastore):
    """The positional form ``(raw_index, points, next_tokens, cfg, grid)``
    warns with ``DeprecationWarning`` and answers as the handle form, as
    the JAX package's; with ``plan`` the wrapped handle is routed."""
    ds = datastore
    vocab = ds["cfg"].vocab
    cfg = tdslsh.make_config(tdslsh.FamilyConfig(**ds["fam"]), tdslsh.BudgetConfig(**BUDGET))
    routed = tdslsh.build(0, ds["pts"], cfg, tdslsh.grid(nu=2, p=4, routed=True), device="cpu", params=ds["family"])
    kw = dict(hidden_fn=lambda c: c, vocab=vocab, lmbda=0.5)
    new_hook = tengine.make_knn_lm_hook(routed, ds["labs"], **kw)
    logits = torch.tensor(np.random.default_rng(2).standard_normal((5, vocab)).astype(np.float32))
    hq = torch.tensor(ds["queries"])
    for plan in (None, routed.plan):
        with pytest.warns(DeprecationWarning, match="deprecated: pass a repro_torch.dslsh Index"):
            legacy = tengine.make_knn_lm_hook(routed.pipeline_index, ds["pts"], ds["labs"], cfg, routed.grid,
                                              plan=plan, **kw)
        assert torch.equal(legacy(logits, hq), new_hook(logits, hq))
    wrapped = tdslsh.wrap_grid(routed.pipeline_index, ds["pts"], cfg, routed.grid, plan=routed.plan)
    assert wrapped.deploy.routed and wrapped.plan is routed.plan
    assert torch.equal(wrapped.query(hq, max_cells=1).knn_idx, routed.query(hq, max_cells=1).knn_idx)
    assert tdslsh.wrap_grid(routed.pipeline_index, ds["pts"], cfg, routed.grid).plan is None


def test_knn_lm_hook_degrade_caps_cells_and_counts_as_jax(datastore):
    """``degrade`` on a routed index: a budget at or above the first level
    queries every routed cell, a shorter one caps the cells probed, each
    capped step counted in ``dslsh_serve_degraded_total{max_cells}`` of
    the active obs bundle; the log-probabilities and the counter are the
    JAX package's on the same routed datastore."""
    from repro import obs as jobs
    from repro_torch import obs as tobs

    ds = datastore
    vocab = ds["cfg"].vocab
    levels = ((10.0, None), (0.0, 1))
    cfg = tdslsh.make_config(tdslsh.FamilyConfig(**ds["fam"]), tdslsh.BudgetConfig(**BUDGET))
    index = tdslsh.build(0, ds["pts"], cfg, tdslsh.grid(nu=2, p=4, routed=True), device="cpu", params=ds["family"])
    jcfg = jdslsh.make_config(jdslsh.FamilyConfig(**ds["fam"]), jdslsh.BudgetConfig(**BUDGET))
    jindex = jdslsh.build(jax.random.PRNGKey(9), jnp.asarray(ds["pts"]), jcfg, jdslsh.grid(nu=2, p=4, routed=True))
    kw = dict(hidden_fn=lambda c: c, vocab=vocab, lmbda=0.5, degrade=levels)
    thook = tengine.make_knn_lm_hook(index, ds["labs"], **kw)
    jhook = jengine.make_knn_lm_hook(jindex, jnp.asarray(ds["labs"]), **kw)
    logits = np.random.default_rng(3).standard_normal((5, vocab)).astype(np.float32)
    hq = torch.tensor(ds["queries"])
    tob, job_ = tobs.Obs(), jobs.Obs()
    outs = {}
    for budget in (100.0, 0.5):
        with tob.activate():
            outs[budget] = thook(torch.tensor(logits), hq, budget)
        with job_.activate():
            want = jhook(jnp.asarray(logits), jnp.asarray(ds["queries"]), budget)
        np.testing.assert_allclose(_np(outs[budget]), np.asarray(want), **TOL)
    for budget, cells in ((100.0, None), (0.5, 1)):
        res = index.query(hq, max_cells=cells)
        direct = tengine.knn_interpolate(torch.tensor(logits), res.knn_idx, res.knn_dist,
                                         torch.tensor(ds["labs"]), vocab, 0.5)
        assert torch.equal(outs[budget], direct)
    name = "dslsh_serve_degraded_total"
    got, want = tob.metrics.snapshot()[name], job_.metrics.snapshot()[name]
    assert got == want and got["values"] == {'max_cells="1"': 1.0}


# ------------------------------------------------------------ the engine
def _jax_and_port_models():
    jcfg = jconfigs.get("granite-8b", smoke=True)
    jmodel = japi.build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = tconfigs.get("granite-8b", smoke=True)
    lm = tparams.model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, tapi.build_model(tcfg), lm


def test_serve_engine_batched_tokens_match_jax():
    """Three prompts of different lengths in one micro-batch: the stacked
    cache holds a different length per row, so every decode step runs the
    per-row ``kv_len`` convention."""
    jmodel, jparams, tmodel, lm = _jax_and_port_models()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (12, 7, 9)]

    def reqs(mod):
        return [mod.Request(rid=i, tokens=p, max_new=5) for i, p in enumerate(prompts)]

    jdone = jengine.ServeEngine(jmodel, jparams, max_batch=3, max_len=32).serve(reqs(jengine))
    tdone = tengine.ServeEngine(tmodel, lm, max_batch=3, max_len=32).serve(reqs(tengine))
    assert [r.result for r in tdone] == [r.result for r in jdone]
    assert all(r.done and not r.timed_out and r.latency_s > 0 for r in tdone)
    # batching changes nothing: each request alone gives the same tokens
    for p, r in zip(prompts, tdone):
        alone = tengine.ServeEngine(tmodel, lm, max_batch=1, max_len=32).serve(
            [tengine.Request(rid=0, tokens=p, max_new=5)])
        assert alone[0].result == r.result


@pytest.fixture(scope="module")
def port_model():
    cfg = tconfigs.get("granite-8b", smoke=True)
    model = tapi.build_model(cfg)
    return model, model.init(0, "cpu")


def test_serve_engine_deadline_mid_decode(port_model):
    model, lm = port_model
    rng = np.random.default_rng(1)
    straggler = tengine.Request(rid=0, tokens=rng.integers(0, 128, 12), max_new=64, deadline_s=0.0)
    healthy = tengine.Request(rid=1, tokens=rng.integers(0, 128, 12), max_new=4)
    done = tengine.ServeEngine(model, lm, max_batch=2, max_len=128).serve([straggler, healthy])
    assert done[0].done and done[0].timed_out and done[0].latency_s > 0.0
    assert len(done[0].result) < done[0].max_new
    assert done[1].done and not done[1].timed_out
    assert len(done[1].result) == 4 and done[1].latency_s > 0.0


def test_serve_engine_completed_request_never_times_out(port_model):
    model, lm = port_model
    rng = np.random.default_rng(3)
    finished = tengine.Request(rid=0, tokens=rng.integers(0, 128, 8), max_new=0, deadline_s=0.0)
    decoding = tengine.Request(rid=1, tokens=rng.integers(0, 128, 8), max_new=3)
    done = tengine.ServeEngine(model, lm, max_batch=2, max_len=64).serve([finished, decoding])
    assert done[0].done and not done[0].timed_out and done[0].latency_s > 0.0
    assert len(done[1].result) == 3 and not done[1].timed_out


def test_serve_engine_all_deadlines_expired_stops_early(port_model):
    model, lm = port_model
    rng = np.random.default_rng(2)
    reqs = [tengine.Request(rid=i, tokens=rng.integers(0, 128, 8), max_new=256, deadline_s=0.0)
            for i in range(2)]
    done = tengine.ServeEngine(model, lm, max_batch=2, max_len=512).serve(reqs)
    assert all(r.done and r.timed_out and r.result == [] and r.latency_s > 0.0 for r in done)


def test_serve_engine_deadline_is_submission_relative(port_model):
    model, lm = port_model
    rng = np.random.default_rng(4)
    stale = tengine.Request(rid=0, tokens=rng.integers(0, 128, 8), max_new=8, deadline_s=5.0,
                            submitted_at=clock.monotonic() - 10.0)  # queued 10 s ago
    fresh = tengine.Request(rid=1, tokens=rng.integers(0, 128, 8), max_new=3, deadline_s=60.0)
    done = tengine.ServeEngine(model, lm, max_batch=2, max_len=64).serve([stale, fresh])
    assert done[0].done and done[0].timed_out and done[0].result == []
    assert done[0].latency_s >= 10.0
    assert done[1].submitted_at > 0.0 and done[1].done and not done[1].timed_out
    assert len(done[1].result) == 3 and done[1].latency_s < 60.0


def test_serve_engine_budget_hook_and_obs(port_model):
    model, lm = port_model
    seen = []

    def hook(logits, carrier, budget_s):
        seen.append((budget_s, tuple(carrier["len"].tolist())))
        return logits

    hook.accepts_budget = True
    reqs = [tengine.Request(rid=0, tokens=np.arange(5), max_new=2, deadline_s=30.0)]
    tengine.ServeEngine(model, lm, max_batch=1, max_len=16, logits_hook=hook).serve(reqs)
    assert [s[1] for s in seen] == [(5,), (6,)] and all(0 < s[0] <= 30.0 for s in seen)
    # without a bundle nothing records; with one, the JAX engine's span and metrics
    from repro_torch import obs as tobs

    assert tengine.ServeEngine(model, lm)._span("serve.batch") is tobs.NULL_SPAN
    ob, active = tobs.Obs(), []

    def spy(logits, carrier):
        active.append(tobs.get_active())
        return logits

    rng = np.random.default_rng(5)
    reqs = [tengine.Request(rid=0, tokens=rng.integers(0, 128, 6), max_new=2),
            tengine.Request(rid=1, tokens=rng.integers(0, 128, 6), max_new=8, deadline_s=0.0)]
    done = tengine.ServeEngine(model, lm, max_batch=1, max_len=16, logits_hook=spy, obs=ob).serve(reqs)
    assert not done[0].timed_out and done[1].timed_out
    assert active and all(a is ob for a in active) and tobs.get_active() is None
    assert [(e["name"], e["args"]) for e in ob.tracer.events] == [("serve.batch", {"requests": 1})] * 2
    snap = ob.metrics.snapshot()
    assert set(snap) == {"dslsh_serve_request_latency_seconds", "dslsh_serve_requests_total",
                         "dslsh_serve_timeouts_total"}
    assert snap["dslsh_serve_request_latency_seconds"]["values"][""]["count"] == 2
    assert snap["dslsh_serve_requests_total"]["values"] == {"": 2.0}
    assert snap["dslsh_serve_timeouts_total"]["values"] == {"": 1.0}


def test_serve_engine_obs_matches_jax():
    """The same requests through both engines with an obs bundle: the same
    span names and attributes and the same metric families, help strings,
    buckets and counts."""
    from repro import obs as jobs
    from repro_torch import obs as tobs

    jmodel, jparams, tmodel, lm = _jax_and_port_models()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (6, 9, 7)]

    def reqs(mod):
        return [mod.Request(rid=i, tokens=p, max_new=2, deadline_s=0.0 if i == 1 else float("inf"))
                for i, p in enumerate(prompts)]

    job_, tob = jobs.Obs(), tobs.Obs()
    jdone = jengine.ServeEngine(jmodel, jparams, max_batch=2, max_len=16, obs=job_).serve(reqs(jengine))
    tdone = tengine.ServeEngine(tmodel, lm, max_batch=2, max_len=16, obs=tob).serve(reqs(tengine))
    assert [(r.result, r.timed_out) for r in tdone] == [(r.result, r.timed_out) for r in jdone]
    strip = [(e["name"], e["args"]) for e in job_.tracer.events]
    assert [(e["name"], e["args"]) for e in tob.tracer.events] == strip
    jsnap, tsnap = job_.metrics.snapshot(), tob.metrics.snapshot()
    assert set(tsnap) == set(jsnap)
    for name, fam in jsnap.items():
        assert tsnap[name]["type"] == fam["type"] and tsnap[name]["help"] == fam["help"], name
        for key, v in fam["values"].items():
            got = tsnap[name]["values"][key]
            if isinstance(v, dict):  # latencies differ; the buckets and the count do not
                assert list(got["buckets"]) == list(v["buckets"]) and got["count"] == v["count"], name
            else:
                assert got == v, name


# ------------------------------------------------------------ the launcher
def test_launcher_serves_a_smoke_config_on_the_cpu(capsys):
    done = tlaunch.main(["--arch", "granite-8b", "--smoke", "--device", "cpu"])
    assert len(done) == 4 and all(len(r.result) == 8 and not r.timed_out for r in done)
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "arch=granite-smoke" in out


def test_launcher_refuses_a_full_config_on_the_cpu():
    with pytest.raises(SystemExit, match="FULL configs need real accelerators"):
        tlaunch.main(["--arch", "granite-8b", "--device", "cpu"])
    with pytest.raises(SystemExit, match="encoder-only"):
        tlaunch.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card behaviour cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "granite-8b", "--smoke"])
