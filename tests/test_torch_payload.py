"""The port's compressed-payload path equals the JAX package's.

Covers ``runtime/payload.py`` and ``runtime/memory.py``, the payload tail's
plain version (``ref.query_tail_payload_ref``, which the ``"cuda"``
backend's wrapper runs on CPU tensors and ``chip_smoke.py`` holds kernel E
to on the card), the payload branch of the pipeline, and the single-shard
handle. The JAX side runs its Pallas payload tail in interpret mode and its
staged oracle; both packages read the same quantized rows, carried across
with ``params.payload_from_numpy``.

Tolerances: quantized ``qdata`` and the scales are exact; ``qerr`` agrees
within rtol 1e-5, since the JAX package sums it in another order. On data
with coordinates on a quarter grid every output is exact. On float data the
counters of stages 3-4 are exact, the top-k is compared tie-aware
(``core.topk.topk_mismatch``, rtol = atol = 1e-5), and ``rerank_misses``
may differ only at candidates whose margin ``ad - qerr - kd[k-1]`` lies
within ``MARGIN_RTOL`` of zero relative to ``kd[k-1]``: the port sums the
approximate distance over ``j`` in ascending order, the JAX package in
XLA's order, so such a candidate can fall on either side.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dslsh as jdslsh
from repro.core import pipeline as jp
from repro.kernels.query_fused import ops as jqf
from repro.kernels.query_fused import ref as jqf_ref
from repro.runtime import memory as jmem
from repro.runtime import payload as jpay
from repro_torch import dslsh as tdslsh
from repro_torch import params as tparams
from repro_torch.core import pipeline as tp
from repro_torch.core import topk as ttopk
from repro_torch.kernels import _build
from repro_torch.kernels.query_fused import ops as tqf
from repro_torch.runtime import memory as tmem
from repro_torch.runtime import payload as tpay

RTOL = ATOL = 1e-5
MARGIN_RTOL = 1e-5
NAMES = ("kd", "ki", "comparisons", "overflow", "rerank_misses")


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    _build.reset_launches()
    yield
    assert _build.LAUNCHES == {}, "a kernel launched on the CPU"


def _np(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _data(n, d=30, seed=2):
    return (np.random.default_rng(seed).standard_normal((n, d)) * 20 + 80).astype(np.float32)


# ------------------------------------------------------------ make_payload


@pytest.mark.parametrize("fmt", ["f16", "i8"])
def test_make_payload_matches_jax(fmt):
    data = _data(200)
    jp_ = jpay.make_payload(jnp.asarray(data), fmt)
    tp_ = tpay.make_payload(torch.as_tensor(data), fmt)
    np.testing.assert_array_equal(_np(tp_.qdata), np.asarray(jp_.qdata))
    np.testing.assert_array_equal(_np(tp_.meta[:, 0]), np.asarray(jp_.meta[:, 0]))
    np.testing.assert_allclose(_np(tp_.meta[:, 1]), np.asarray(jp_.meta[:, 1]), rtol=1e-5)
    assert tp_.nbytes == jp_.nbytes == tmem.payload_nbytes(200, 30, fmt)
    assert tmem.payload_nbytes(200, 30, fmt) == jmem.payload_nbytes(200, 30, fmt)
    for c_rerank in (8, 2000):
        assert tpay.tail_gather_bytes(1024, c_rerank, 30, fmt) == jpay.tail_gather_bytes(1024, c_rerank, 30, fmt)


def test_make_payload_rejects_unknown_format_as_jax_does():
    with pytest.raises(ValueError) as je:
        jpay.make_payload(jnp.zeros((4, 3)), "f64")
    with pytest.raises(ValueError) as te:
        tpay.make_payload(torch.zeros((4, 3)), "f64")
    assert str(te.value) == str(je.value)


def test_payload_from_numpy_refuses_f32_rows():
    with pytest.raises(ValueError, match="float16 or int8"):
        tparams.payload_from_numpy(np.zeros((4, 3), np.float32), np.zeros((4, 2)), "cpu")


# ------------------------------------------------------------- the tail


def _tail_inputs(seed, q_n=4, d=13, n=90, run=8, windows=3, fill=0.7, grid=True):
    """JAX's ``tests/test_out_of_core.py`` recipe in numpy: run-sorted rows of
    ``windows`` runs, partly filled; coordinates on a quarter grid (exact
    sums, so distance ties) or, with ``grid=False``, uniform floats."""
    rng = np.random.default_rng(seed)
    data = rng.random((n, d)).astype(np.float32) * 4
    qs = rng.random((q_n, d)).astype(np.float32) * 4
    if grid:
        data, qs = np.round(data) / 4, np.round(qs) / 4
    vals = np.sort(rng.integers(0, n, (q_n, windows, run)), axis=-1)
    cnt = np.where(rng.random((q_n, windows, 1)) < fill, rng.integers(0, run + 1, (q_n, windows, 1)), 0)
    cand = np.where(np.arange(run) < cnt, vals, -1).reshape(q_n, windows * run).astype(np.int32)
    return data.astype(np.float32), qs.astype(np.float32), cand, run


def _both(data, qs, cand, run, fmt, kernel=True, **kw):
    """(JAX interpret kernel or None, JAX oracle, port) outputs on the JAX
    payload."""
    jpl = jpay.make_payload(jnp.asarray(data), fmt)
    tpl = tparams.payload_from_numpy(jpl.qdata, jpl.meta, "cpu")
    jargs = (jnp.asarray(data), jpl.qdata, jpl.meta, jnp.asarray(qs), jnp.asarray(cand))
    jk = jqf.query_tail_payload(*jargs, run=run, interpret=True, **kw) if kernel else None
    jr = jqf_ref.query_tail_payload_ref(*jargs, **kw)
    tout = tqf.query_tail_payload(
        torch.as_tensor(data), tpl.qdata, tpl.meta, torch.as_tensor(qs), torch.as_tensor(cand), run=run, **kw
    )
    return jk, jr, tout, tpl


@pytest.mark.parametrize("fmt", ["f16", "i8"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_payload_tail_exact_on_grid_data(fmt, seed):
    data, qs, cand, run = _tail_inputs(seed)
    jk, jr, tout, _ = _both(data, qs, cand, run, fmt, c_comp=24, c_rerank=8, k=5)
    assert [t.dtype for t in tout] == [torch.float32] + [torch.int32] * 4
    for jout in (jk, jr):
        for g, w, name in zip(tout, jout, NAMES):
            np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("fmt", ["f16", "i8"])
@pytest.mark.parametrize("c_rerank", [40, 48])
def test_payload_tail_k_past_the_warp_form(fmt, c_rerank):
    # k = 40 > 32 (kernel E sorts the block's keys) with a shortlist of at
    # least k: every output exact on grid data, a tight cluster so that
    # misses are counted
    data, qs, cand, run = _tail_inputs(6, q_n=5, n=400, run=16, windows=8, fill=1.0)
    data, qs = 80.0 + data * 0.05, 80.0 + qs * 0.05
    jk, jr, tout, _ = _both(data, qs, cand, run, fmt, c_comp=56, c_rerank=c_rerank, k=40)
    assert tout[0].shape == (5, 40) and int(tout[2].min()) > 40
    for jout in (jk, jr):
        for g, w, name in zip(tout, jout, NAMES):
            np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    if fmt == "i8":
        assert int(tout[4].sum()) > 0


def _miss_flags(data, qdata, meta, qs, cand, c_comp, c_rerank, kd_k, ad_of):
    """Per compacted position: (miss flag, margin ad - qerr - kd[k-1]), with
    ``ad_of(deq_minus_q_abs) -> ad`` summing the approximate distance."""
    comp = np.sort(np.where(cand >= 0, cand, np.iinfo(np.int32).max), axis=-1)
    first = np.ones_like(comp, bool)
    first[:, 1:] = comp[:, 1:] != comp[:, :-1]
    comp = np.sort(np.where(first, comp, np.iinfo(np.int32).max), axis=-1)[:, :c_comp]
    valid = comp != np.iinfo(np.int32).max
    safe = np.where(valid, comp, 0)
    diff = np.abs(qdata[safe].astype(np.float32) * meta[safe, 0:1] - qs[:, None, :])
    ad = np.where(valid, ad_of(diff), np.inf).astype(np.float32)
    short = np.argsort(ad, axis=-1, kind="stable")[:, : min(c_rerank, ad.shape[1])]
    in_short = np.zeros_like(valid)
    np.put_along_axis(in_short, short, True, axis=-1)
    margin = np.where(valid, ad - meta[safe, 1] - np.where(np.isinf(kd_k), 0, kd_k)[:, None], np.inf)
    margin = np.where(np.isinf(kd_k)[:, None] & valid, -np.inf, margin)
    return valid & ~in_short & (margin <= 0), margin


def _seq_sum(diff):
    ad = np.zeros(diff.shape[:-1], np.float32)
    for j in range(diff.shape[-1]):
        ad = ad + diff[..., j]
    return ad


@pytest.mark.parametrize("fmt", ["f16", "i8"])
@pytest.mark.parametrize("seed", [1, 4, 9])
def test_payload_tail_on_float_data(fmt, seed):
    data, qs, cand, run = _tail_inputs(seed, fill=0.9, grid=False)
    # a tight cluster far from the origin: quantization errors reach the
    # k-th distance, so candidates on either side of the margin occur
    data, qs = 200.0 + data * 0.25, 200.0 + qs * 0.25
    kw = dict(c_comp=24, c_rerank=8, k=5)
    jk, jr, tout, tpl = _both(data, qs, cand, run, fmt, **kw)
    dist_of = lambda rows, idx: (torch.as_tensor(data)[idx.long()] - torch.as_tensor(qs)[rows]).abs().sum(-1)  # noqa: E731
    qdata, meta = _np(tpl.qdata), _np(tpl.meta)
    for jout in (jk, jr):
        for i in (2, 3):
            np.testing.assert_array_equal(_np(tout[i]), np.asarray(jout[i]), err_msg=NAMES[i])
        why = ttopk.topk_mismatch(tout[0], tout[1], torch.tensor(np.asarray(jout[0])),
                                  torch.tensor(np.asarray(jout[1])), dist_of, rtol=RTOL, atol=ATOL)
        assert why is None, why
        # the miss counts differ only at candidates on the margin's edge
        t_flags, margin = _miss_flags(data, qdata, meta, qs, cand, kw["c_comp"], kw["c_rerank"],
                                      _np(tout[0])[:, -1], _seq_sum)
        j_flags, _ = _miss_flags(data, qdata, meta, qs, cand, kw["c_comp"], kw["c_rerank"],
                                 np.asarray(jout[0])[:, -1], lambda x: np.asarray(jnp.sum(jnp.asarray(x), -1)))
        np.testing.assert_array_equal(t_flags.sum(-1), _np(tout[4]))
        np.testing.assert_array_equal(j_flags.sum(-1), np.asarray(jout[4]))
        edge = np.abs(margin) <= MARGIN_RTOL * np.maximum(np.abs(_np(tout[0])[:, -1:]), 1.0)
        assert not (t_flags != j_flags)[~edge].any(), np.argwhere((t_flags != j_flags) & ~edge)


@pytest.mark.parametrize("fmt", ["f16", "i8"])
def test_full_shortlist_certifies_the_f32_tail(fmt):
    """c_rerank == c_comp reranks every survivor: no miss, and kd/ki equal
    the f32 tail's exactly (both packages)."""
    data, qs, cand, run = _tail_inputs(7)
    jk, jr, tout, _ = _both(data, qs, cand, run, fmt, c_comp=24, c_rerank=24, k=5)
    t32 = tqf.query_tail(*map(torch.as_tensor, (data, qs, cand)), run=run, c_comp=24, k=5)
    j32 = jqf.query_tail(*map(jnp.asarray, (data, qs, cand)), run=run, c_comp=24, k=5, interpret=True)
    assert int(tout[4].sum()) == 0
    for i in range(4):
        assert torch.equal(tout[i], t32[i]), NAMES[i]
        np.testing.assert_array_equal(_np(tout[i]), np.asarray(j32[i]), err_msg=NAMES[i])
    for g, w, name in zip(tout, jk, NAMES):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)


def test_starved_shortlist_counts_misses():
    """A shortlist smaller than the survivors counts the at-risk exclusions
    (i8's wide error bound on a tight cluster flags them), bounded by the
    candidates outside the shortlist."""
    data, qs, cand, run = _tail_inputs(5, fill=1.0)
    data, qs = 80.0 + data * 0.05, 80.0 + qs * 0.05
    _, jr, tout, _ = _both(data, qs, cand, run, "i8", kernel=False, c_comp=24, c_rerank=5, k=5)
    misses = _np(tout[4])
    assert misses.sum() > 0
    outside = np.maximum(np.minimum(_np(tout[2]), 24) - 5, 0)
    assert (misses <= outside).all()
    np.testing.assert_array_equal(_np(tout[2]), np.asarray(jr[2]))


# ------------------------------------------------- pipeline and handle


def _cfg_kw(**kw):
    return dict(
        m_out=12, L_out=6, m_in=6, L_in=3, alpha=0.02, k=5, val_lo=20.0,
        val_hi=180.0, c_max=32, c_in=8, h_max=4, p_max=64, c_comp=128,
        c_rerank=16, query_chunk=8, **kw,
    )


@pytest.fixture(scope="module")
def jax_handles():
    data = _data(256)
    qs = (data[:20] + np.random.default_rng(9).standard_normal((20, 30)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(1)
    out = {"data": data, "qs": qs}
    for fmt in ("f16", "i8"):
        cfg = jp.SLSHConfig.compose(**_cfg_kw(backend="pallas", payload=fmt))
        out["family"] = jp.make_family(key, 30, cfg)
        idx = jdslsh.build(key, jnp.asarray(data), cfg, jdslsh.single())
        out[fmt] = (idx.query(jnp.asarray(qs)), idx.memory_report())
    return out


@pytest.mark.parametrize("fmt", ["f16", "i8"])
def test_handle_matches_jax(jax_handles, fmt):
    data, qs = jax_handles["data"], jax_handles["qs"]
    jres, jrep = jax_handles[fmt]
    cfg = tdslsh.make_config(**_cfg_kw(payload=fmt))
    index = tdslsh.build(0, data, cfg, tdslsh.single(), device="cpu", params=jax_handles["family"])
    res = index.query(qs)
    for name in ("comparisons", "compaction_overflow", "routed", "rerank_misses"):
        np.testing.assert_array_equal(_np(getattr(res, name)), np.asarray(getattr(jres, name)), err_msg=name)
    assert res.rerank_misses.shape == (1, 1, 20) and res.rerank_miss_total == jres.rerank_miss_total
    why = ttopk.topk_mismatch(
        res.knn_dist, res.knn_idx, torch.tensor(np.asarray(jres.knn_dist)),
        torch.tensor(np.asarray(jres.knn_idx)),
        lambda rows, idx: (torch.as_tensor(data)[idx.long()] - torch.as_tensor(qs)[rows]).abs().sum(-1),
        rtol=RTOL, atol=ATOL,
    )
    assert why is None, why
    rep = index.memory_report()
    assert rep.components["payload"] == jrep.components["payload"] == 256 * (30 * tpay.payload_itemsize(fmt) + 8)
    assert rep.components["data"] == jrep.components["data"] and rep.cells == (1, 1)
    assert rep.to_dict()["total_bytes"] == rep.total == sum(rep.components.values())
    assert index._payload() is index._payload()  # made once, then cached


def test_pipeline_payload_with_no_miss_equals_f32(jax_handles):
    """Where a query has no miss its answer equals the f32 pipeline's; the
    payload is made once per batch when the caller holds none."""
    data, qs = map(torch.as_tensor, (jax_handles["data"], jax_handles["qs"]))
    outer, inner = tparams.from_jax_params(*jax_handles["family"], "cpu")
    cfg = tp.SLSHConfig.compose(**_cfg_kw())
    index = tp.build_from_params(data, outer, inner, cfg)
    r32 = tp.query_batch(index, data, qs, cfg)
    assert r32.rerank_misses is None
    for fmt in ("f16", "i8"):
        rp = tp.query_batch(index, data, qs, cfg.replace(payload=fmt))
        ok = rp.rerank_misses == 0
        assert rp.rerank_misses.shape == (20,) and bool(ok.any())
        assert torch.equal(rp.knn_idx[ok], r32.knn_idx[ok]) and torch.equal(rp.knn_dist[ok], r32.knn_dist[ok])
        assert torch.equal(rp.comparisons, r32.comparisons)


def test_grid_refuses_a_compressed_payload_as_jax_does():
    data = _data(256)
    with pytest.raises(jp.ConfigError) as je:
        jdslsh.build(jax.random.PRNGKey(1), jnp.asarray(data),
                     jp.SLSHConfig.compose(**_cfg_kw(backend="pallas", payload="f16")), jdslsh.grid(nu=2, p=2))
    with pytest.raises(tp.ConfigError) as te:
        tdslsh.build(0, data, tdslsh.make_config(**_cfg_kw(payload="f16")), tdslsh.grid(nu=2, p=2), device="cpu")
    assert str(te.value) == str(je.value)
    grid = tdslsh.build(0, data, tdslsh.make_config(**_cfg_kw()), tdslsh.grid(nu=2, p=2), device="cpu")
    res = grid.query(data[:3])
    assert res.rerank_misses is None and res.rerank_miss_total == 0
    rep = grid.memory_report()
    assert rep.cells == (2, 2) and rep.components["payload"] == 0
    assert rep.per_cell["data"] == rep.components["data"] // 4
