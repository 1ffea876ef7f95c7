"""The port's streaming path against the JAX package's (DESIGN.md §9).

The same numpy data and the JAX hash family (carried across with
``params.from_jax_params``) go through ``repro.stream`` on the
``"reference"`` backend and through ``repro_torch.stream`` on the port's
``"torch"`` and ``"cuda"`` backends (the latter's kernels run their plain
versions on CPU tensors). Integers must be equal, distances within
rtol = atol = 1e-5 and indices tie-aware (``core.topk.topk_mismatch``).
Inside the port a streaming query must equal a from-scratch build over
base ∪ delta bit for bit, before and after ``compact``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import stream as jstream
from repro.core import distributed as jD
from repro.core import pipeline as jp
from repro_torch import api, params
from repro_torch import stream as tstream
from repro_torch.core import distributed as tD
from repro_torch.core import pipeline as tp
from repro_torch.core import topk as ttopk

RTOL = ATOL = 1e-5
BACKENDS = ("torch", "cuda")
CPU = torch.device("cpu")


def _np(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _base(**kw) -> dict:
    base = dict(
        m_out=12, L_out=8, m_in=8, L_in=4, alpha=0.02, k=10,
        val_lo=0.0, val_hi=1.0, c_max=64, c_in=16, h_max=4, p_max=128,
        build_chunk=200, query_chunk=16,
    )
    base.update(kw)
    return base


def _cfgs(backend: str, **kw):
    b = _base(**kw)
    return jp.SLSHConfig.compose(**b, backend="reference"), tp.SLSHConfig.compose(**b, backend=backend)


def _uniform(n=512, d=12, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (n, d)).astype(np.float32)


def _heavy_data(d=8) -> np.ndarray:
    """One tight cluster spanning base and delta + uniform noise, so the
    base's heavy registry agrees with the union's (the §9 precondition):
    [300 cluster, 100 noise | 60 cluster, 40 noise] (base | delta)."""
    rng = np.random.default_rng(5)
    cluster = (0.5 + 0.004 * rng.standard_normal((360, d))).astype(np.float32)
    noise = rng.uniform(0, 1, (140, d)).astype(np.float32)
    return np.concatenate([cluster[:300], noise[:100], cluster[300:], noise[100:]])


def _family(cfg_j, d: int, seed: int = 1):
    """The JAX family from ``PRNGKey(seed)`` in both packages' types."""
    fam_j = jp.make_family(jax.random.PRNGKey(seed), d, cfg_j)
    return fam_j, params.from_jax_params(*fam_j, CPU)


def _assert_same(res_t, res_j, pts, queries, what: str):
    for name in ("comparisons", "bucket_total", "compaction_overflow"):
        np.testing.assert_array_equal(_np(getattr(res_t, name)), _np(getattr(res_j, name)), err_msg=f"{what}:{name}")
    pts_t, q_t = torch.as_tensor(pts), torch.as_tensor(np.asarray(queries))
    why = ttopk.topk_mismatch(
        res_t.knn_dist, res_t.knn_idx, torch.as_tensor(_np(res_j.knn_dist)), torch.as_tensor(_np(res_j.knn_idx)),
        lambda rows, idx: (pts_t[idx.long()] - q_t[rows]).abs().sum(-1), rtol=RTOL, atol=ATOL,
    )
    assert why is None, f"{what}: {why}"


def _assert_equal(a, b, what: str):
    for name in ("knn_idx", "knn_dist", "comparisons", "bucket_total", "compaction_overflow"):
        assert torch.equal(getattr(a, name), getattr(b, name)), f"{what}:{name}"


def _stream_split(data, n_base, cfg, fam, *, jax_side: bool, batches=3, cap_extra=17):
    """Build on data[:n_base] in one package, stream the rest in batches."""
    n = data.shape[0]
    if jax_side:
        base = jp.build_from_params(jnp.asarray(data[:n_base]), *fam, cfg)
        sidx = jstream.from_base(base, jnp.asarray(data[:n_base]), cfg, capacity=n + cap_extra, delta_cap=n - n_base)
        insert, conv = jstream.insert_batch, jnp.asarray
    else:
        sidx = tstream.stream_init(fam, torch.as_tensor(data[:n_base]), cfg, capacity=n + cap_extra,
                                   delta_cap=n - n_base)
        insert, conv = tstream.insert_batch, torch.as_tensor
    extra = data[n_base:]
    step = -(-extra.shape[0] // batches)
    for b in range(batches):
        chunk = extra[b * step : (b + 1) * step]
        if chunk.shape[0]:
            sidx = insert(sidx, conv(chunk), cfg, t=float(b))
    return sidx


_JAX: dict = {}  # the JAX side of a case, computed once for both port backends


def _jax_once(name: str, fn):
    if name not in _JAX:
        _JAX[name] = fn()
    return _JAX[name]


EQUIV_CASES = [
    pytest.param(dict(use_inner=False, multiprobe=2), 380, "uniform", id="no_inner+multiprobe"),
    pytest.param(
        dict(m_out=10, L_out=4, m_in=4, L_in=2, alpha=0.05, c_max=512, c_in=512, h_max=4, p_max=512, query_chunk=8),
        400, "heavy", id="inner",
    ),
    pytest.param(
        dict(m_out=10, L_out=4, m_in=4, L_in=2, alpha=0.05, c_max=512, c_in=512, h_max=4, p_max=320, query_chunk=8),
        400, "heavy", id="inner+pmax_cap",
    ),
    pytest.param(dict(use_inner=False, c_comp=48), 380, "uniform", id="no_inner+compact"),
]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kw,n_base,dataset", EQUIV_CASES)
def test_insert_then_query_matches_scratch_build_and_jax(backend, kw, n_base, dataset):
    """Streaming == a from-scratch union build (exactly) == JAX's streaming
    answer, before and after compact."""
    cfg_j, cfg_t = _cfgs(backend, **kw)
    data = _heavy_data() if dataset == "heavy" else _uniform()
    fam = _family(cfg_j, data.shape[1])
    st = _stream_split(data, n_base, cfg_t, fam[1], jax_side=False)
    assert st.delta.dropped == 0 and st.delta.count == data.shape[0] - n_base
    union = tp.build_from_params(torch.as_tensor(data), *fam[1], cfg_t)
    if dataset == "heavy":
        assert bool(union.heavy.valid.any()), "the case must exercise the inner layer"
    q = data[:16] + 0.003 * np.random.default_rng(2).standard_normal((16, data.shape[1])).astype(np.float32)
    res_u = tp.query_batch(union, torch.as_tensor(data), torch.as_tensor(q), cfg_t)
    if "c_comp" in kw:  # the compaction case must bind the budget
        assert int(res_u.compaction_overflow.max()) > 0
    res_t = tstream.query_batch(st, q, cfg_t)
    _assert_equal(res_t, res_u, "pre-compact vs union")
    res_j = _jax_once(repr(kw), lambda: jstream.query_batch(
        _stream_split(data, n_base, cfg_j, fam[0], jax_side=True), jnp.asarray(q), cfg_j
    ))
    _assert_same(res_t, res_j, data, q, "pre-compact vs JAX")
    ct = tstream.compact(st, cfg_t)
    assert ct.delta.count == 0 and ct.base.n == data.shape[0]
    _assert_equal(tstream.query_batch(ct, q, cfg_t), res_u, "post-compact vs union")


@pytest.mark.parametrize("backend", BACKENDS)
def test_compact_reproduces_scratch_tables(backend):
    """compact is bit-exact with a from-scratch build (merged CSR rows, the
    heavy registry, the inner tables; inert padding) and with JAX's."""
    cfg_j, cfg_t = _cfgs(
        backend, m_out=10, L_out=4, m_in=4, L_in=2, alpha=0.05, c_max=512, c_in=512, h_max=4, p_max=512, query_chunk=8,
    )
    data = _heavy_data()
    n = data.shape[0]
    fam = _family(cfg_j, data.shape[1])
    st = _stream_split(data, 400, cfg_t, fam[1], jax_side=False, batches=2, cap_extra=23)
    union = tp.build_from_params(torch.as_tensor(data), *fam[1], cfg_t)
    c = tstream.compact(st, cfg_t)
    cj = _jax_once("compact", lambda: jstream.compact(
        _stream_split(data, 400, cfg_j, fam[0], jax_side=True, batches=2, cap_extra=23), cfg_j
    ))
    assert c.base.n == n
    assert torch.equal(c.base.outer.sorted_keys[:, :n], union.outer.sorted_keys)
    assert torch.equal(c.base.outer.sorted_idx[:, :n], union.outer.sorted_idx)
    assert bool((c.base.outer.sorted_idx[:, n:] == -1).all())
    np.testing.assert_array_equal(_np(c.base.outer.sorted_keys), np.asarray(cj.base.outer.sorted_keys).astype(np.int64))
    np.testing.assert_array_equal(_np(c.base.outer.sorted_idx), np.asarray(cj.base.outer.sorted_idx))
    for a, b, bj in zip(c.base.heavy, union.heavy, cj.base.heavy):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(_np(a), np.asarray(bj).astype(_np(a).dtype))
    for field in ("inner_keys", "inner_idx"):
        assert torch.equal(getattr(c.base, field), getattr(union, field))
        np.testing.assert_array_equal(
            _np(getattr(c.base, field)), np.asarray(getattr(cj.base, field)).astype(_np(getattr(c.base, field)).dtype)
        )


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_delta_is_identity(backend):
    """A fresh stream index answers as the plain pipeline does."""
    _, cfg_t = _cfgs(backend, use_inner=True)
    data = torch.as_tensor(_uniform())
    fam = tp.family_from_key(1, data.shape[1], cfg_t, CPU)
    idx = tp.build_from_params(data, *fam, cfg_t)
    sidx = tstream.stream_init(fam, data, cfg_t, capacity=600, delta_cap=32)
    q = data[:12]
    _assert_equal(tstream.query_batch(sidx, q, cfg_t), tp.query_batch(idx, data, q, cfg_t), "empty delta")


def test_insert_overflow_drops_and_counts():
    _, cfg_t = _cfgs("cuda", use_inner=False)
    data = torch.as_tensor(_uniform(n=128))
    sidx = tstream.stream_init(0, data[:100], cfg_t, capacity=120, delta_cap=64)
    sidx = tstream.insert_batch(sidx, data[100:], cfg_t)  # store room (20) binds before delta_cap (64)
    assert (sidx.delta.count, sidx.delta.dropped, sidx.n_total) == (20, 8, 120)
    assert torch.equal(sidx.store[100:120], data[100:120])
    res = tstream.query_batch(sidx, data[:4], cfg_t)
    assert bool((res.knn_idx < 120).all())


def test_evict_before_drops_stale_and_renumbers():
    _, cfg_t = _cfgs("cuda", use_inner=False)
    data = torch.as_tensor(_uniform(n=300))
    sidx = tstream.stream_init(0, data[:200], cfg_t, capacity=400, delta_cap=128, t0=0.0)
    sidx = tstream.insert_batch(sidx, data[200:], cfg_t, t=10.0)
    new, keep = tstream.evict_before(sidx, cfg_t, t_min=5.0)
    assert new.base.n == 100
    assert keep.tolist() == list(range(200, 300))
    res = tstream.query_batch(new, data[200:204], cfg_t)
    assert res.knn_idx[:, 0].tolist() == [0, 1, 2, 3] and bool((res.knn_dist[:, 0] == 0).all())
    same, keep_all = tstream.evict_before(sidx, cfg_t, t_min=-1.0)
    assert same.base.n == 300 and keep_all.shape[0] == 300
    # everything stale: the newest h_max windows survive
    gone, keep_new = tstream.evict_before(sidx, cfg_t, t_min=1e9)
    assert gone.base.n == cfg_t.h_max and keep_new.tolist() == list(range(296, 300))


def _monitor_pair(backend: str, route: bool = True):
    """A maker of the JAX monitor and the port monitor at
    tests/test_stream.py's replay sizes, with the stream to replay."""
    b = _base(m_out=10, L_out=4, m_in=6, L_in=2, alpha=0.05, k=4, c_max=32, c_in=8, h_max=2, p_max=64, query_chunk=8)
    cfg_j = jp.SLSHConfig.compose(**b, backend="reference")
    cfg_t = tp.SLSHConfig.compose(**b, backend=backend)
    rng = np.random.default_rng(0)
    init_pts = rng.uniform(0, 1, (64, 8)).astype(np.float32)
    init_lab = rng.integers(0, 2, 64).astype(np.int8)
    spts = rng.uniform(0, 1, (80, 8)).astype(np.float32)
    slab = rng.integers(0, 2, 80).astype(np.int8)
    fam_j = jp.make_family(jax.random.PRNGKey(0), 8, cfg_j)
    kw = dict(node_capacity=96, delta_cap=16, retention_s=50.0, route=route)
    def mon_j():  # built only where a test needs the JAX side
        return jstream.StreamingMonitor(jax.random.PRNGKey(0), init_pts, init_lab, cfg_j, jD.Grid(nu=2, p=2), **kw)

    mon_t = tstream.StreamingMonitor(
        params.from_jax_params(*fam_j, CPU), init_pts, init_lab, cfg_t, tD.Grid(nu=2, p=2), device="cpu", **kw
    )
    return mon_j, mon_t, (spts, slab, np.arange(80.0))


@pytest.mark.parametrize("backend", BACKENDS)
def test_monitor_replay_matches_jax_event_by_event(backend):
    """64 warm points, 80 streamed in batches of 8 on grid(2, 2) with
    node_capacity 96, delta_cap 16, retention 50 s: the stream compacts and
    evicts, and every event equals JAX's."""
    mon_j, mon_t, (spts, slab, ts) = _monitor_pair(backend)
    def jax_replay():
        mon = mon_j()
        return mon.replay(spts, slab, ts, batch_size=8), mon.mcc(), mon.labels.copy()

    ev_j, mcc_j, labels_j = _jax_once("replay", jax_replay)
    ev_t = mon_t.replay(spts, slab, ts, batch_size=8)
    assert len(ev_t) == len(ev_j) == 10
    assert any(e.compacted for e in ev_t) and sum(e.evicted for e in ev_t) > 0
    for a, b in zip(ev_t, ev_j):
        for f in ("node", "inserted", "dropped", "compacted", "evicted", "preds", "labels", "comparisons", "overflow",
                  "n_index", "routed_frac"):
            assert getattr(a, f) == getattr(b, f), (f, a.t)
    assert mon_t.mcc() == pytest.approx(mcc_j, abs=1e-6)
    np.testing.assert_array_equal(mon_t.labels, labels_j)


def test_routed_monitor_equals_unrouted_and_finds_delta_only_points():
    """Routing is exact on the delta path: a routed monitor answers as an
    unrouted one before and after compaction, routes real sparsity, and a
    point held only in a delta segment is still found."""
    _, mon_t, _ = _monitor_pair("cuda")
    plain = mon_t.core.clone(route=False)
    rng = np.random.default_rng(1)
    novel = rng.uniform(2.0, 3.0, (4, 8)).astype(np.float32)  # a far cluster
    rep = mon_t.core.ingest(novel, t=1.0)
    q = torch.as_tensor(np.concatenate([novel, rng.uniform(0, 1, (8, 8)).astype(np.float32)]))
    for phase in ("pre-compact", "post-compact"):
        if phase == "post-compact":
            mon_t.core.compact_all(2.0)
        plain.state = list(mon_t.core.state)
        rt, rf = mon_t._query(mon_t.state, q), plain._query(plain.state, q)
        for a, b in zip(rt[:4], rf[:4]):
            assert torch.equal(a, b), phase
        assert not bool((~rt[4] & (rf[2] > 0)).any()) and not bool(rt[4].all()), phase
        assert rt[1][:4, 0].tolist() == (rep.slots + rep.node * 96).tolist(), phase
        assert bool((rt[0][:4, 0] == 0).all()), phase


def test_monitor_label_delay_prevents_lookahead():
    """With label_delay_s set, a streamed window's label stays hidden (votes
    as non-AHE) until its condition window closes, then reveals."""
    _, cfg_t = _cfgs("cuda", m_out=8, L_out=4, k=2, use_inner=False, c_max=64, query_chunk=8)
    rng = np.random.default_rng(7)
    init_pts = rng.uniform(0, 1, (32, 8)).astype(np.float32)
    mon = tstream.StreamingMonitor(
        0, init_pts, np.zeros(32, np.int8), cfg_t, tD.Grid(nu=1, p=1),
        node_capacity=64, delta_cap=16, label_delay_s=10.0, device="cpu",
    )
    w = rng.uniform(0, 1, (1, 8)).astype(np.float32)
    mon.ingest(w, np.ones(1, np.int8), t=0.0)
    assert mon.predict(w)[0][0] == 0, "label must stay hidden before reveal time"
    mon.flush_labels(now=5.0)
    assert mon.predict(w)[0][0] == 0
    mon.flush_labels(now=10.0)
    assert mon.predict(w)[0][0] == 1, "label must reveal once the window closes"
    assert mon._pending_labels == []


def test_monitor_merge_never_duplicates_neighbours():
    """Cells of one node split tables, not data: a self-hit surfaces in
    every cell's partial top-K and must fill exactly one slot."""
    _, cfg_t = _cfgs("cuda", m_out=8, L_out=8, k=6, use_inner=False, c_max=64, query_chunk=8)
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (64, 8)).astype(np.float32)
    mon = tstream.StreamingMonitor(
        0, pts, np.zeros(64, np.int8), cfg_t, tD.Grid(nu=1, p=4), node_capacity=96, delta_cap=16, device="cpu",
    )
    mon.ingest(rng.uniform(0, 1, (8, 8)).astype(np.float32), np.zeros(8, np.int8), 1.0)
    kd, ki, _, _, _ = mon._query(mon.state, torch.as_tensor(pts[:8]))
    assert ki[:, 0].tolist() == list(range(8)) and bool((kd[:, 0] == 0).all())
    for row_i, row_d in zip(ki, kd):
        valid = row_i >= 0
        assert len(set(row_i[valid].tolist())) == int(valid.sum())
        assert bool(torch.isinf(row_d[~valid]).all())


def test_snapshot_keeps_its_answers_through_ingest_and_compaction():
    """A snapshot shares the handle's tensors; later ingests and a
    compaction of the handle must not change a single answer of it."""
    cfg = api.make_config(**_base(m_out=10, L_out=4, m_in=6, L_in=2, alpha=0.05, k=4, c_max=32, c_in=8,
                                  h_max=2, p_max=64, query_chunk=8))
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (64, 8)).astype(np.float32)
    index = api.build(0, pts, cfg, api.streaming(nu=2, p=2, node_capacity=96, delta_cap=16), device="cpu")
    index.ingest(rng.uniform(0, 1, (8, 8)).astype(np.float32), 1.0)
    snap = index.snapshot()
    q = rng.uniform(0, 1, (12, 8)).astype(np.float32)
    before = snap.query(q)
    n_before = snap.n_index()
    for t in range(2, 8):
        index.ingest(rng.uniform(0, 1, (8, 8)).astype(np.float32), float(t))
    index.compact(9.0)
    assert index.n_index() == n_before + 48 and snap.n_index() == n_before
    after = snap.query(q)
    for a, b in zip(before[:5], after[:5]):
        assert torch.equal(a, b)
    assert not torch.equal(index.query(q).comparisons, before.comparisons)


def test_streaming_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card behaviour cannot show")
    cfg = api.make_config(m_out=8, L_out=4, m_in=4, L_in=2, k=3, h_max=2, p_max=32)
    pts = np.random.default_rng(0).random((32, 8), dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.build(0, pts, cfg, api.streaming(node_capacity=64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstream.StreamingMonitor(0, pts, np.zeros(32, np.int8), cfg, tD.Grid(nu=1, p=1), node_capacity=64, delta_cap=8)
    index = api.build(0, pts, cfg, api.streaming(node_capacity=64), device="cpu")
    assert index.device == CPU and index.n_index() == 32
    with pytest.raises(api.ConfigError, match="memory_report"):
        index.memory_report()
