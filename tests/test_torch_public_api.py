"""Public functions of the JAX package that the port copies, each against
its JAX counterpart on the same numpy inputs: ``api.wrap_single``,
``hashing.probe_keys_bitsample`` (keys equal), ``topk.cosine_distances``
(float32, rtol = atol = 1e-6), ``pipeline.register_backend`` with a factory
that ``get_backend(name, cfg)`` resolves, and the deprecated
``distributed.simulate_query`` and ``simulate_query_routed`` shims (the
same warning class, the grid query's fields bit for bit, and JAX's answer).

Hash families come from JAX's ``make_family``/``make_bitsample`` and are
carried across as numpy; top-k indices compare tie-aware
(``core.topk.topk_mismatch``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import distributed as jD
from repro.core import hashing as jh
from repro.core import pipeline as jp
from repro.core import routing as jr
from repro.core import slsh as jslsh
from repro.core import topk as jk
from repro_torch import api
from repro_torch import params as tparams
from repro_torch.core import distributed as tD
from repro_torch.core import hashing as th
from repro_torch.core import pipeline as tp
from repro_torch.core import routing as tr
from repro_torch.core import topk as tk

RTOL = ATOL = 1e-5  # neighbour distances: the L1 sums in another order
COS_TOL = 1e-6  # cosine distances in float32 over d = 30
BASE = dict(m_out=12, L_out=8, m_in=6, L_in=4, alpha=0.02, k=5, val_lo=0.0, val_hi=1.0, c_max=32, c_in=8,
            h_max=4, p_max=64, build_chunk=128, query_chunk=8)


def _clustered(n=512, d=12, seed=1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1, (n // 16, 1, d))
    return (centers + 0.01 * rng.standard_normal((n // 16, 16, d))).reshape(-1, d).astype(np.float32)


def _queries(data: np.ndarray, n=16) -> np.ndarray:
    return (data[:n] + 0.001 * np.random.default_rng(9).standard_normal((n, data.shape[1]))).astype(np.float32)


def _np(a) -> np.ndarray:
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def _assert_topk(kd, ki, ref_d, ref_i, data, q):
    pts, qt = torch.as_tensor(data), torch.as_tensor(q)
    why = tk.topk_mismatch(
        kd, ki, torch.tensor(_np(ref_d)), torch.tensor(_np(ref_i)),
        lambda rows, idx: (pts[idx.long()] - qt[rows]).abs().sum(-1), rtol=RTOL, atol=ATOL,
    )
    assert why is None, why


@pytest.mark.parametrize("n_probes", [0, 3])
def test_probe_keys_bitsample_matches_jax_exactly(n_probes):
    rng = np.random.default_rng(2)
    x = (20.0 + 160.0 * rng.random((6, 30))).astype(np.float32)
    outer = jh.make_bitsample(jax.random.PRNGKey(3), 5, 20, 30, 20.0, 180.0)
    inner = jh.make_signrp(jax.random.PRNGKey(4), 2, 8, 30)
    t_outer, _ = tparams.from_jax_params(outer, inner, "cpu")
    for row in x:
        want = jh.probe_keys_bitsample(outer, jnp.asarray(row), n_probes)
        got = th.probe_keys_bitsample(t_outer, torch.as_tensor(row), n_probes)
        assert tuple(got.shape) == (5, 1 + n_probes)
        np.testing.assert_array_equal(_np(got), _np(want))


def test_cosine_distances_match_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal(30).astype(np.float32)
    pts = rng.standard_normal((64, 30)).astype(np.float32)
    pts[5] = 0.0  # a zero row: the 1e-9 guard, as JAX has it
    want = np.asarray(jk.cosine_distances(jnp.asarray(q), jnp.asarray(pts)))
    got = tk.cosine_distances(torch.as_tensor(q), torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=COS_TOL, atol=COS_TOL)


def test_wrap_single_answers_as_jax_wrap_single():
    data = _clustered()
    q = _queries(data)
    jcfg = jp.SLSHConfig.compose(**BASE, backend="reference")
    jidx = jslsh.build_index(jax.random.PRNGKey(0), jnp.asarray(data), jcfg)
    jres = japi.wrap_single(jidx, data, jcfg).query(jnp.asarray(q))
    outer, inner = jp.make_family(jax.random.PRNGKey(0), data.shape[1], jcfg)
    cfg = api.make_config(**BASE, backend="torch")
    t_outer, t_inner = tparams.from_jax_params(outer, inner, "cpu")
    tidx = tp.build_from_params(torch.as_tensor(data), t_outer, t_inner, cfg)
    handle = api.wrap_single(tidx, data, cfg)
    assert handle.deploy.kind == "single" and handle._state["data"].dtype == torch.float32
    res = handle.query(q)
    np.testing.assert_array_equal(_np(res.comparisons), _np(jres.comparisons))
    np.testing.assert_array_equal(_np(res.compaction_overflow), _np(jres.compaction_overflow))
    _assert_topk(res.knn_dist, res.knn_idx, jres.knn_dist, jres.knn_idx, data, q)
    # the same answer as the handle dslsh.build makes from the same family
    built = api.build(0, data, cfg, api.single(), device="cpu", params=(outer, inner)).query(q)
    assert torch.equal(built.knn_idx, res.knn_idx) and torch.equal(built.comparisons, res.comparisons)


def test_register_backend_resolves_factories_with_the_config():
    """A factory entry is called with the config ``get_backend`` is given,
    in both packages, and a query through it answers as the plain backend
    does (and as JAX's through its own factory)."""
    data = _clustered(n=256)
    q = _queries(data, 8)
    seen = {"jax": [], "torch": []}

    def jax_factory(cfg):
        seen["jax"].append(cfg)
        return jp.get_backend("reference")

    def torch_factory(cfg):
        seen["torch"].append(cfg)
        return tp.get_backend("torch")

    jp.register_backend("_factory", jax_factory)
    tp.register_backend("_factory", torch_factory)
    try:
        jcfg = jp.SLSHConfig.compose(**BASE, backend="_factory")
        cfg = api.make_config(**BASE, backend="_factory")
        assert isinstance(tp.get_backend("_factory", cfg), tp.BackendOps)
        assert seen["torch"][-1] is cfg
        jidx = jslsh.build_index(jax.random.PRNGKey(0), jnp.asarray(data), jcfg)
        jres = jslsh.query_batch(jidx, jnp.asarray(data), jnp.asarray(q), jcfg)
        outer, inner = jp.make_family(jax.random.PRNGKey(0), data.shape[1], jcfg)
        res = api.build(0, data, cfg, api.single(), device="cpu", params=(outer, inner)).query(q)
        assert any(c is cfg for c in seen["torch"]) and seen["jax"]
        plain = api.build(0, data, cfg.replace(backend="torch"), api.single(), device="cpu",
                          params=(outer, inner)).query(q)
        assert torch.equal(res.knn_idx, plain.knn_idx) and torch.equal(res.comparisons, plain.comparisons)
        np.testing.assert_array_equal(_np(res.comparisons[0, 0]), _np(jres.comparisons))
        _assert_topk(res.knn_dist, res.knn_idx, jres.knn_dist, jres.knn_idx, data, q)
        # a plain BackendOps entry resolves as it is
        ops = tp.get_backend("torch")
        tp.register_backend("_plain", ops)
        assert tp.get_backend("_plain", cfg) is ops
    finally:
        jp._BACKENDS.pop("_factory", None)
        tp._BACKENDS.pop("_factory", None)
        tp._BACKENDS.pop("_plain", None)
    with pytest.raises(ValueError, match="unknown SLSH backend"):
        tp.get_backend("_factory")


@pytest.mark.parametrize("routed", [False, True], ids=["broadcast", "routed"])
def test_deprecated_simulate_query_shims_match_jax(routed):
    data = _clustered()
    q = _queries(data)
    jcfg = jp.SLSHConfig.compose(**BASE, backend="reference")
    jgrid = jD.Grid(nu=4, p=2)
    jidx = jD.simulate_build(jax.random.PRNGKey(0), jnp.asarray(data), jcfg, jgrid)
    family = jp.make_family(jax.random.PRNGKey(0), data.shape[1], jcfg)
    cfg = api.make_config(**BASE, backend="torch")
    handle = api.build(0, data, cfg, api.grid(4, 2), device="cpu", params=family)
    args = (handle.pipeline_index, handle._state["data"], torch.as_tensor(q), cfg, handle.grid)
    if routed:
        jplan = jr.make_plan(jidx, jcfg, jgrid, replication=2)
        plan = tr.make_plan(handle.pipeline_index, cfg, handle.grid, replication=2)
        with pytest.warns(DeprecationWarning, match="simulate_query_routed is deprecated"):
            want = jD.simulate_query_routed(jidx, jnp.asarray(data), jnp.asarray(q), jcfg, jgrid, jplan,
                                            return_stats=True)
        with pytest.warns(DeprecationWarning, match="simulate_query_routed is deprecated"):
            got = tD.simulate_query_routed(*args, plan, return_stats=True)
        typed, stats = tD.grid_query(*args, plan=plan, return_stats=True)
        np.testing.assert_array_equal(got[4].routed, want[4].routed)
        np.testing.assert_array_equal(got[4].routed, stats.routed)
        got, want = got[:4], want[:4]
    else:
        with pytest.warns(DeprecationWarning, match="simulate_query is deprecated"):
            want = jD.simulate_query(jidx, jnp.asarray(data), jnp.asarray(q), jcfg, jgrid)
        with pytest.warns(DeprecationWarning, match="simulate_query is deprecated"):
            got = tD.simulate_query(*args)
        typed = tD.grid_query(*args)
    assert len(got) == 4
    for a, f in zip(got, ("knn_dist", "knn_idx", "comparisons", "compaction_overflow")):
        assert torch.equal(a, getattr(typed, f)), f
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(_np(a), _np(b))
    _assert_topk(got[0], got[1], want[0], want[1], data, q)
