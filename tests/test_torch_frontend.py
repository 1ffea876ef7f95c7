"""The port's serving front end against the JAX package's (DESIGN.md §15).

The coalescer's partitions and the admission verdicts must equal JAX's on
the same seeded sequences (both are pure Python). The front end's cases are
those of ``tests/test_frontend.py`` and ``tests/test_frontend_chaos.py`` on
the port: coalesced answers bit-exact against a solo ``Index.query``, a
flat ``obs.query_retraces()`` after warmup, EDF order, deadline
degradation and expiry, shedding, RCU ingest while serving, the
``AsyncFrontend`` and the oversize refusal. The tenant-burst and cell-kill
scenario runs on both packages (the same data, queries and hash family)
and every verdict, status, flag and ledger count must be equal.
"""
from __future__ import annotations

import asyncio
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import chaos as jchaos
from repro.core import pipeline as jp
from repro.serve import admission as jadmission
from repro.serve import coalesce as jcoalesce
from repro.serve import frontend as jfrontend
from repro_torch import api, params
from repro_torch import obs as tobs
from repro_torch.core import pipeline as tp
from repro_torch.core import topk as ttopk
from repro_torch.runtime import elastic as telastic
from repro_torch.serve import admission, coalesce
from repro_torch.serve import frontend as frontend_mod

CPU = torch.device("cpu")
D = 12
RTOL = ATOL = 1e-5


def _cfg(**kw):
    base = dict(
        m_out=12, L_out=8, m_in=6, L_in=4, alpha=0.02, k=5,
        val_lo=0.0, val_hi=1.0, c_max=32, c_in=8, h_max=4, p_max=64,
        build_chunk=128, query_chunk=8, backend="torch",
    )
    base.update(kw)
    return tp.SLSHConfig.compose(**base)


@pytest.fixture(scope="module")
def grid_index():
    rng = np.random.default_rng(0)
    data = rng.uniform(0.0, 1.0, (256, D)).astype(np.float32)
    idx = api.build(0, data, _cfg(), api.grid(nu=2, p=2, routed=True), device="cpu")
    return idx, data


# ------------------------------------------------------------------ coalescer


class _Stub:
    """A queue entry carrying just what the coalescer reads."""

    def __init__(self, rid, nq, deadline_at=math.inf):
        self.rid = rid
        self.queries = np.full((nq, 3), float(rid), np.float32)
        self.deadline_at = deadline_at


def _drain(co, sizes, deadlines):
    queue = [_Stub(i, n, d) for i, (n, d) in enumerate(zip(sizes, deadlines))]
    out = []
    while queue:
        before = [r.rid for r in queue]
        mb = co.form(queue)
        assert [r.rid for r in mb.requests] + [r.rid for r in queue] == before
        assert mb.bucket == coalesce.bucket_for(mb.n_real, co.ladder)
        assert mb.padding == mb.bucket - mb.n_real >= 0
        np.testing.assert_array_equal(mb.queries[mb.n_real:], np.broadcast_to(mb.queries[:1], (mb.padding, 3)))
        out.append(([r.rid for r in mb.requests], mb.spans, mb.n_real, mb.bucket, mb.deadline_at, mb.queries))
    return out


def test_coalescer_partitions_match_jax_seeded():
    rng = np.random.default_rng(7)
    ladders = [(8, 32, 128, 512), (4, 16), (1, 2, 3, 5, 8), (7,)]
    for trial in range(200):
        ladder = ladders[trial % len(ladders)]
        sizes = rng.integers(1, ladder[-1] + 1, rng.integers(1, 12)).tolist()
        deadlines = rng.uniform(0, 10, len(sizes)).tolist()
        got = _drain(coalesce.Coalescer(ladder), sizes, deadlines)
        want = _drain(jcoalesce.Coalescer(ladder), sizes, deadlines)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a[:5] == b[:5]
            np.testing.assert_array_equal(a[5], b[5])
        seen = [rid for batch in got for rid in batch[0]]
        assert sorted(seen) == list(range(len(sizes)))  # exactly once


def test_bucket_for_bounds_as_jax():
    assert coalesce.BUCKET_LADDER == jcoalesce.BUCKET_LADDER == (8, 32, 128, 512)
    assert [coalesce.bucket_for(n) for n in range(1, 513)] == [jcoalesce.bucket_for(n) for n in range(1, 513)]
    for bad in (0, 513):
        with pytest.raises(ValueError):
            coalesce.bucket_for(bad)
    with pytest.raises(ValueError):
        coalesce.Coalescer((8, 8, 32))


# ------------------------------------------------------------------ admission


def test_admission_verdicts_match_jax_seeded():
    rng = np.random.default_rng(11)
    quotas = {"a": dict(rate_qps=3.0, burst=6.0, degrade_overdraft=3.0), "b": dict(rate_qps=1.0, burst=2.0)}
    ctl_t = admission.AdmissionController({k: admission.TenantQuota(**v) for k, v in quotas.items()}, max_queue=20)
    ctl_j = jadmission.AdmissionController({k: jadmission.TenantQuota(**v) for k, v in quotas.items()}, max_queue=20)
    t = 0.0
    for _ in range(300):
        tenant = ["a", "b", "c"][int(rng.integers(0, 3))]
        n, depth = int(rng.integers(1, 6)), int(rng.integers(0, 20))
        assert ctl_t.admit(tenant, n, depth, now=t) == ctl_j.admit(tenant, n, depth, now=t)
        t += float(rng.uniform(0.0, 0.7))
    assert dataclasses.asdict(ctl_t.stats) == dataclasses.asdict(ctl_j.stats)
    assert ctl_t.stats.shed > 0 and ctl_t.stats.degraded > 0 and ctl_t.stats.shed_queue_full > 0
    ctl_t.stats.check()


def test_admission_token_bucket_verdicts():
    ob = tobs.Obs(trace=False)
    ctl = admission.AdmissionController(
        {"t": admission.TenantQuota(rate_qps=2.0, burst=4.0, degrade_overdraft=2.0)}, max_queue=100,
    )
    with ob.activate():
        v = [ctl.admit("t", 2, 0, now=0.0) for _ in range(4)]
        assert v == ["admit", "admit", "degrade", "shed"]
        assert ctl.admit("t", 1, 0, now=1.0) == "degrade"
        assert ctl.admit("t", 1, 0, now=2.0) == "admit"
    s = ctl.stats
    assert (s.submitted, s.admitted, s.degraded, s.shed) == (6, 3, 2, 1)
    s.check()
    snap = ob.snapshot()
    assert snap["dslsh_serve_admitted_total"]["values"] == {'verdict="admit"': 3.0, 'verdict="degrade"': 2.0,
                                                            'verdict="shed"': 1.0}
    assert snap["dslsh_serve_shed_total"]["values"] == {'tenant="t"': 1.0}
    b = admission.TokenBucket(rate_qps=2.0, burst=4.0)
    assert (b.take(4, now=0.0), b.take(1, now=0.0), b.take(1, now=0.5)) == (True, False, True)


def test_admission_queue_backpressure_and_default_quota():
    ctl = admission.AdmissionController(max_queue=10)
    assert ctl.admit("anyone", 8, 0, now=0.0) == "admit"
    assert ctl.admit("anyone", 8, 8, now=0.0) == "shed"
    assert ctl.stats.shed_queue_full == 1
    ctl.stats.check()


# ------------------------------------------------------------------ front end


def test_coalesced_results_bitexact_vs_solo_query(grid_index):
    idx, data = grid_index
    rng = np.random.default_rng(3)
    fe = idx.frontend(frontend_mod.FrontendConfig(ladder=(8, 32)))
    reqs = []
    for _ in range(5):
        nq = int(rng.integers(1, 7))
        q = (data[rng.integers(0, len(data), nq)] + rng.normal(0, 0.01, (nq, D))).astype(np.float32)
        reqs.append((fe.submit(q, now=0.0), q))
    fe.drain(now=0.0)
    for req, q in reqs:
        assert req.status == "done" and not req.degraded
        solo = idx.query(q)
        np.testing.assert_array_equal(req.knn_dist, solo.knn_dist.numpy())
        np.testing.assert_array_equal(req.knn_idx, solo.knn_idx.numpy())
    fe.assert_conserved()


def test_steady_state_serving_retraces_nothing(grid_index):
    idx, data = grid_index
    rng = np.random.default_rng(5)
    ob = tobs.Obs(trace=False)
    fe = idx.frontend(frontend_mod.FrontendConfig(ladder=(8, 32), degrade=((0.5, None), (0.0, 2))), obs=ob)
    assert fe.warmup() == 4  # 2 rungs x 2 levels
    r0 = tobs.query_retraces()
    t = 0.0
    for i in range(12):
        q = data[rng.integers(0, len(data), int(rng.integers(1, 30)))].astype(np.float32)
        fe.submit(q, deadline_s=(0.1 if i % 3 else 1e6), now=t)
        fe.pump(now=t)
        t += 0.05
    fe.drain(now=t)
    assert tobs.query_retraces() == r0, "steady state must not build or construct anything"
    s = fe.assert_conserved()
    snap = ob.snapshot()
    assert snap["dslsh_serve_goodput_total"]["values"][""] + snap.get(
        "dslsh_serve_frontend_timeouts_total", {"values": {"": 0.0}})["values"][""] == s.completed + s.timed_out
    assert snap["dslsh_serve_queries_served_total"]["values"][""] > 0


def test_deadline_degradation_and_expiry(grid_index):
    idx, data = grid_index
    q = data[:4].astype(np.float32)
    fe = idx.frontend(frontend_mod.FrontendConfig(ladder=(8,), degrade=((0.5, None), (0.0, 2))))
    loose = fe.submit(q, deadline_s=10.0, now=0.0)
    fe.pump(now=0.0)
    assert loose.status == "done" and not loose.degraded
    tight = fe.submit(q, deadline_s=0.1, now=1.0)
    fe.pump(now=1.0)
    assert tight.status == "done" and tight.degraded and tight.max_cells == 2
    capped = idx.query(q, max_cells=2)
    np.testing.assert_array_equal(tight.knn_idx, capped.knn_idx.numpy())
    stale = fe.submit(q, deadline_s=1.0, now=2.0)
    out = fe.pump(now=10.0)
    assert stale in out and stale.status == "timed_out" and stale.knn_dist is None
    s = fe.assert_conserved()
    assert s.timed_out == 1 and s.completed == 2


def test_degrade_config_requires_routed_deployment():
    data = np.random.default_rng(0).uniform(0.0, 1.0, (64, D)).astype(np.float32)
    idx = api.build(0, data, _cfg(), api.single(), device="cpu")
    with pytest.raises(ValueError, match="routed"):
        idx.frontend(frontend_mod.FrontendConfig(degrade=((0.0, 2),)))


def test_frontend_sheds_over_quota_and_counts(grid_index):
    idx, data = grid_index
    q = data[:4].astype(np.float32)
    fe = idx.frontend(frontend_mod.FrontendConfig(
        ladder=(8,), quotas=(("burst", admission.TenantQuota(rate_qps=1.0, burst=4.0)),),
    ))
    ok = fe.submit(q, tenant="burst", now=0.0)
    shed = fe.submit(torch.as_tensor(q), tenant="burst", now=0.0)  # a tensor is a batch too
    free = fe.submit(q, tenant="other", now=0.0)
    assert ok.status == "queued" and free.status == "queued"
    assert shed.status == "shed" and shed.verdict == "shed"
    fe.drain(now=0.0)
    s = fe.assert_conserved()
    assert (s.submitted, s.completed, s.shed) == (3, 2, 1)


def test_edf_orders_tightest_deadline_first(grid_index):
    idx, data = grid_index
    q8 = data[:8].astype(np.float32)
    fe = idx.frontend(frontend_mod.FrontendConfig(ladder=(8,)))
    loose = fe.submit(q8, deadline_s=100.0, now=0.0)
    tight = fe.submit(q8, deadline_s=1.0, now=0.0)
    assert fe.pump(now=0.0) == [tight] and loose.status == "queued"
    fe.drain(now=0.0)
    assert loose.status == "done"
    fe.assert_conserved()


def test_rcu_ingest_while_serving_swaps_epochs():
    rng = np.random.default_rng(2)
    data = rng.uniform(0.0, 1.0, (128, D)).astype(np.float32)
    extra = rng.uniform(0.0, 1.0, (32, D)).astype(np.float32)
    idx = api.build(0, data, _cfg(), api.streaming(nu=2, node_capacity=256, delta_cap=64), device="cpu")
    q = data[:4] + rng.normal(0, 0.01, (4, D)).astype(np.float32)
    before_solo = idx.query(q)
    fe = idx.frontend()
    fe.warmup()
    r0 = tobs.query_retraces()
    a = fe.submit(q, now=0.0)
    fe.pump(now=0.0)
    n0 = fe.index.n_index()
    rep = fe.ingest(extra, ts=1.0)
    assert rep.inserted == 32
    b = fe.submit(q, now=1.0)
    fe.pump(now=1.0)
    assert (a.epoch, b.epoch) == (0, 1)
    assert fe.index.n_index() == n0 + 32 and idx.n_index() == n0  # the old epoch never moved
    np.testing.assert_array_equal(a.knn_dist, before_solo.knn_dist.numpy())
    np.testing.assert_array_equal(a.knn_idx, before_solo.knn_idx.numpy())
    after_solo = fe.index.query(q)
    np.testing.assert_array_equal(b.knn_dist, after_solo.knn_dist.numpy())
    np.testing.assert_array_equal(b.knn_idx, after_solo.knn_idx.numpy())
    assert tobs.query_retraces() == r0, "RCU clones must share the streaming programs"
    fe.assert_conserved()


def test_snapshot_isolates_batch_and_streaming():
    data = np.random.default_rng(4).uniform(0.0, 1.0, (64, D)).astype(np.float32)
    b = api.build(0, data, _cfg(), api.single(), device="cpu")
    assert b.snapshot() is b
    s = api.build(0, data, _cfg(), api.streaming(nu=2, node_capacity=128, delta_cap=32), device="cpu")
    snap = s.snapshot()
    assert snap is not s
    snap.ingest(data[:8], 1.0)
    assert snap.n_index() == s.n_index() + 8


def test_async_frontend_awaitable_submit(grid_index):
    idx, data = grid_index
    q = data[:4].astype(np.float32)
    fe = idx.frontend(frontend_mod.FrontendConfig(ladder=(8,)))
    solo = idx.query(q)

    async def main():
        async with frontend_mod.AsyncFrontend(fe) as af:
            return await asyncio.gather(*(af.submit(q, tenant=f"t{i}") for i in range(3)))

    for r in asyncio.run(main()):
        assert r.status == "done" and not r.degraded
        np.testing.assert_array_equal(r.knn_dist, solo.knn_dist.numpy())
    fe.assert_conserved()


def test_oversized_request_rejected_at_submit(grid_index):
    idx, data = grid_index
    fe = idx.frontend(frontend_mod.FrontendConfig(ladder=(8,)))
    with pytest.raises(ValueError, match="ladder"):
        fe.submit(data[:9].astype(np.float32), now=0.0)


# ------------------------------------------------------- admission under chaos


def _beat_all(elastic, t, dead=()):
    for dev in range(elastic.n_devices):
        if dev not in dead:
            elastic.beat(dev, t=t)


def _burst_and_kill(fe, elastic, q, cell_devices, warm: bool) -> list:
    """``tests/test_frontend_chaos.py``'s schedule: a healthy phase, a
    tenant burst over quota, then cell (0, 0)'s only replica stops beating.
    Returns every ticket in submission order."""
    if warm:
        fe.warmup()
    _beat_all(elastic, 0.1)
    tickets = [fe.submit(q[0:4], tenant="steady", now=0.1), fe.submit(q[4:8], tenant="steady", now=0.1)]
    fe.pump(now=0.1)
    fe.assert_conserved()
    _beat_all(elastic, 1.0)
    tickets += [fe.submit(q[i * 4:(i + 1) * 4], tenant="burst", now=1.0) for i in range(4)]
    fe.pump(now=1.0)
    fe.assert_conserved()
    dead = set(cell_devices)
    _beat_all(elastic, 2.0, dead=dead)
    _beat_all(elastic, 3.5, dead=dead)
    tickets += [fe.submit(q[0:4], tenant="steady", now=3.5), fe.submit(q[8:12], tenant="steady", now=3.5)]
    fe.pump(now=3.5)
    return tickets


def test_tenant_burst_and_cell_kill_exact_counts():
    jcl = jchaos.make_cluster(seed=0, nu=2, p=2, replication=1, n=256, n_queries=16, deadline_s=1.0)
    data = np.array(jcl.data, np.float32)
    q = np.array(jcl.queries, np.float32)
    kw = {f.name: getattr(jcl.cfg, f.name) for f in dataclasses.fields(jcl.cfg)}
    cfg = tp.SLSHConfig.compose(**{**kw, "backend": "torch", "interpret": None})
    family = params.from_jax_params(*jp.make_family(jax.random.PRNGKey(0), D, jcl.cfg), CPU)
    tidx = api.build(0, data, cfg, api.grid(nu=2, p=2, replication=1, routed=True), device="cpu", params=family)
    healthy = tidx.query(q)
    tel = telastic.ElasticIndex(tidx, deadline_s=1.0, now=0.0)
    fcfg = dict(ladder=(4, 8, 16), degrade=((0.25, None), (0.0, 1)))
    quota = dict(rate_qps=4.0, burst=8.0, degrade_overdraft=4.0)
    fe_t = frontend_mod.ServeFrontend(tel, frontend_mod.FrontendConfig(
        **fcfg, quotas=(("burst", admission.TenantQuota(**quota)),)))
    fe_j = jfrontend.ServeFrontend(jcl.elastic, jfrontend.FrontendConfig(
        **fcfg, quotas=(("burst", jadmission.TenantQuota(**quota)),)))
    cell = [int(d) for d in tidx.plan.cell_device[0, 0] if d >= 0]
    got = _burst_and_kill(fe_t, tel, q, cell, warm=True)
    want = _burst_and_kill(fe_j, jcl.elastic, q, cell, warm=False)  # warmup changes no count
    for a, b in zip(got, want):
        assert (a.rid, a.tenant, a.verdict, a.status, a.degraded, a.max_cells, a.epoch) == (
            b.rid, b.tenant, b.verdict, b.status, b.degraded, b.max_cells, b.epoch)
        if a.knn_idx is not None:
            np.testing.assert_array_equal(a.knn_idx >= 0, np.asarray(b.knn_idx) >= 0)
            pts, qt = torch.as_tensor(data), torch.as_tensor(a.queries)
            why = ttopk.topk_mismatch(
                torch.as_tensor(a.knn_dist), torch.as_tensor(a.knn_idx), torch.as_tensor(np.array(b.knn_dist)),
                torch.as_tensor(np.array(b.knn_idx)),
                lambda rows, idx: (pts[idx.long()] - qt[rows]).abs().sum(-1), rtol=RTOL, atol=ATOL)
            assert why is None, why
    assert [r.verdict for r in got[2:6]] == ["admit", "admit", "degrade", "shed"]
    for r, (lo, hi) in zip(got[:2], ((0, 4), (4, 8))):  # exact: the healthy rows, bit for bit
        assert r.status == "done" and not r.degraded
        np.testing.assert_array_equal(r.knn_dist, healthy.knn_dist[lo:hi].numpy())
        np.testing.assert_array_equal(r.knn_idx, healthy.knn_idx[lo:hi].numpy())
    assert all(r.degraded and r.max_cells == 1 for r in got[2:5])
    assert all(r.degraded and r.max_cells is None and r.epoch == 0 for r in got[6:])
    s_t, s_j = fe_t.assert_conserved(), fe_j.assert_conserved()
    assert dataclasses.asdict(s_t) == dataclasses.asdict(s_j)
    assert (s_t.submitted, s_t.admitted, s_t.shed, s_t.completed, s_t.timed_out, s_t.degraded_responses,
            s_t.in_queue) == (8, 7, 1, 7, 0, 5, 0)
    assert dataclasses.asdict(fe_t.admission.stats) == dataclasses.asdict(fe_j.admission.stats)


def test_flapping_burst_sheds_deterministically(grid_index):
    """The same burst schedule on two fresh front ends gives identical
    verdicts and counters, with both sheds and admits in it."""
    idx, data = grid_index
    q = data[:8].astype(np.float32)

    def run():
        fe = idx.frontend(frontend_mod.FrontendConfig(
            ladder=(4, 8), quotas=(("t", admission.TenantQuota(rate_qps=2.0, burst=4.0, degrade_overdraft=2.0)),),
        ))
        rng = np.random.default_rng(9)
        verdicts, t = [], 0.0
        for _ in range(12):
            verdicts.append(fe.submit(q[:int(rng.integers(1, 5))], tenant="t", now=t).verdict)
            fe.pump(now=t)
            t += float(rng.uniform(0.1, 0.6))
        s = fe.assert_conserved()
        return verdicts, (s.submitted, s.shed, s.completed, s.timed_out)

    v1, c1 = run()
    assert (v1, c1) == run()
    assert "shed" in v1 and "admit" in v1
