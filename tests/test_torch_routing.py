"""The port's key→cell routing against the JAX package's (DESIGN.md §10).

Every function of ``core/routing.py`` on the same numpy inputs, and the
routed grid query: on a routed grid (replication 1 and 2, multiprobe,
``drop_mask``, ``max_cells``) the port's answer must equal its own
broadcast answer bit for bit in ``knn_idx``, ``knn_dist``, ``comparisons``
and ``compaction_overflow``, and JAX's routed answer (the family carried
across with ``params.from_jax_params``) with integers equal, distances
within rtol = atol = 1e-5 and indices tie-aware.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jD
from repro.core import pipeline as jp
from repro.core import routing as jr
from repro_torch import api
from repro_torch.core import distributed as tD
from repro_torch.core import routing as tr
from repro_torch.core import topk as ttopk

RTOL = ATOL = 1e-5


def _np(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _base(**kw) -> dict:
    base = dict(
        m_out=12, L_out=8, m_in=6, L_in=4, alpha=0.02, k=5,
        val_lo=0.0, val_hi=1.0, c_max=32, c_in=8, h_max=4, p_max=64,
        build_chunk=128, query_chunk=8,
    )
    base.update(kw)
    return base


def _clustered(n=512, d=12, seed=1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1, (n // 16, 1, d))
    return (centers + 0.01 * rng.standard_normal((n // 16, 16, d))).reshape(-1, d).astype(np.float32)


# --------------------------------------------------------- pure functions


def test_coarse_slot_and_occupancy_maps_match_jax():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, (2, 2, 3, 40), dtype=np.uint64).astype(np.uint32)
    keys[0, 0, 0, -3:] = 0xFFFFFFFF  # capacity padding past n_valid
    n_valid = np.asarray([[37, 40], [12, 1]], np.int32)
    kt = torch.as_tensor(keys.astype(np.int64))
    for bits in (4, 12):
        np.testing.assert_array_equal(_np(tr.coarse_slot(kt, bits)), np.asarray(jr.coarse_slot(jnp.asarray(keys), bits)))
        np.testing.assert_array_equal(
            _np(tr.key_cell_map(kt, torch.as_tensor(n_valid), bits)),
            np.asarray(jr.key_cell_map(jnp.asarray(keys), jnp.asarray(n_valid), bits)),
        )
        np.testing.assert_array_equal(
            _np(tr.cell_occupancy(kt[1, 0], 12, bits)),
            np.asarray(jr.cell_occupancy(jnp.asarray(keys[1, 0]), 12, bits)),
        )
        dk = keys[0, 1].T  # (cap, L_loc)
        valid = np.arange(40) < 25
        np.testing.assert_array_equal(
            _np(tr.delta_occupancy(torch.as_tensor(dk.astype(np.int64)), torch.as_tensor(valid), bits, 1 << bits)),
            np.asarray(jr.delta_occupancy(jnp.asarray(dk), jnp.asarray(valid), bits, 1 << bits)),
        )
    occ = jr.cell_occupancy(jnp.asarray(keys[0, 1]), 40, 6)
    pk = rng.integers(0, 2**32, (9, 3, 2), dtype=np.uint64).astype(np.uint32)
    pk[:4] = keys[0, 1, :, :8].T[:4, :, None]  # some keys that do land
    np.testing.assert_array_equal(
        _np(tr.route_cell(torch.as_tensor(np.asarray(occ)), torch.as_tensor(pk.astype(np.int64)))),
        np.asarray(jr.route_cell(occ, jnp.asarray(pk))),
    )


def test_route_mask_budget_and_degrade_match_jax():
    rng = np.random.default_rng(1)
    grid_j, grid_t = jD.Grid(nu=3, p=2), tD.Grid(nu=3, p=2)
    occ = rng.random((3, 8, 64)) < 0.3
    pk = rng.integers(0, 2**32, (11, 8, 3), dtype=np.uint64).astype(np.uint32)
    rj, sj = jr.route_mask(jnp.asarray(occ), jnp.asarray(pk), grid_j)
    rt, st = tr.route_mask(torch.as_tensor(occ), torch.as_tensor(pk.astype(np.int64)), grid_t)
    np.testing.assert_array_equal(_np(rt), np.asarray(rj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj))
    for cap in (1, 2, 4, 6, 9):
        np.testing.assert_array_equal(
            _np(tr.apply_cell_budget(rt, st, cap)), np.asarray(jr.apply_cell_budget(rj, sj, cap))
        )
    levels = ((0.1, None), (0.05, 4), (0.0, 1))
    for b in (1.0, 0.07, 0.01, -5.0):
        assert tr.degrade_max_cells(b, levels) == jr.degrade_max_cells(b, levels)


def test_apply_cell_budget_caps_and_prioritizes():
    routed = torch.ones((3, 2, 2), dtype=torch.bool)
    scores = torch.tensor([[[3, 1], [2, 0]], [[1, 1], [1, 1]], [[0, 4], [4, 0]]], dtype=torch.int32)
    capped = tr.apply_cell_budget(routed, scores, 2)
    assert int(capped.sum()) == 6
    assert bool(capped[0, 0, 0]) and bool(capped[0, 1, 0])
    assert bool(capped[1, 0, 0]) and bool(capped[1, 0, 1])  # ties: lowest cell ids
    assert bool(capped[2, 0, 1]) and bool(capped[2, 1, 0])
    assert torch.equal(tr.apply_cell_budget(routed, scores, 4), routed)


def _rand_partials(rng, s, q, k):
    """Partials with engineered distance ties and -1 pads, rows ascending."""
    kd = rng.choice([0.25, 0.5, 1.0, 2.0], size=(s, q, k)).astype(np.float32)
    ki = rng.integers(0, 50, size=(s, q, k)).astype(np.int32)
    pad = rng.random((s, q, k)) < 0.2
    kd[pad] = np.inf
    ki[pad] = -1
    order = np.argsort(kd, axis=-1, kind="stable")
    return np.take_along_axis(kd, order, axis=-1), np.take_along_axis(ki, order, axis=-1)


@pytest.mark.parametrize("s", [1, 2, 3, 5, 12])
@pytest.mark.parametrize("k", [1, 5])
def test_merges_match_jax_with_ties(s, k):
    rng = np.random.default_rng(100 * s + k)
    kd, ki = _rand_partials(rng, s, 6, k)
    assert tr.tournament_rounds(s) == jr.tournament_rounds(s)
    td, ti = tr.merge_partials_tree(torch.as_tensor(kd), torch.as_tensor(ki), k)
    fd, fi = tr.merge_partials_flat(torch.as_tensor(kd), torch.as_tensor(ki), k)
    jd, ji = jr.merge_partials_tree(jnp.asarray(kd), jnp.asarray(ki), k)
    for a, b in ((td, fd), (ti, fi)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    owner = jr.replica_owner(6, 2)
    np.testing.assert_array_equal(tr.replica_owner(6, 2), owner)
    kr_t = tr.split_replicas(torch.as_tensor(kd[0]), torch.as_tensor(ki[0]), torch.as_tensor(owner), 3)
    kr_j = jr.split_replicas(jnp.asarray(kd[0]), jnp.asarray(ki[0]), jnp.asarray(owner), 3)
    for a, b in zip(kr_t, kr_j):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    for a, b in zip(tr.merge_replica_partials(*kr_t, k), jr.merge_replica_partials(*kr_j, k)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_placement_and_accounting_match_jax():
    reps = np.asarray([[2, 1, 3], [1, 1, 2]], np.int32)
    np.testing.assert_array_equal(tr.deal_devices(reps), jr.deal_devices(reps))
    rng = np.random.default_rng(4)
    rows = rng.random((6, 9)) < 0.5
    assert tr.merge_payload(rows, 5) == jr.merge_payload(rows, 5)
    occ = np.zeros((2, 6, 16), bool)
    plan_t = tr.RoutingPlan(torch.as_tensor(occ), reps, np.zeros((2, 3), np.float32), tr.deal_devices(reps))
    plan_j = jr.RoutingPlan(jnp.asarray(occ), reps, np.zeros((2, 3), np.float32), jr.deal_devices(reps))
    routed = rng.random((10, 2, 3)) < 0.6
    np.testing.assert_array_equal(tr.device_load(plan_t, routed), jr.device_load(plan_j, routed))
    new = np.asarray([[1, 2, 1], [3, 1, 1]], np.int32)
    for a, b in zip(tr.replan(plan_t, new)[1:], jr.replan(plan_j, new)[1:]):
        np.testing.assert_array_equal(a, b)
    down = rng.random(plan_t.n_devices) < 0.4
    np.testing.assert_array_equal(tr.live_replicas(plan_t, down), jr.live_replicas(plan_j, down))
    assert (plan_t.bits, plan_t.r_max, plan_t.n_devices) == (plan_j.bits, plan_j.r_max, plan_j.n_devices)
    with pytest.raises(ValueError, match="at least one replica"):
        tr.replan(plan_t, np.zeros((2, 3), np.int32))


# ------------------------------------------------------------ routed grids


_JAX: dict = {}


def _jax_index(kw: dict, nu: int, p: int, data: np.ndarray):
    """JAX's grid index over ``data`` and its family, built once."""
    key = (repr(kw), nu, p)
    if key not in _JAX:
        cfg = jp.SLSHConfig.compose(**_base(**kw), backend="reference")
        grid = jD.Grid(nu=nu, p=p)
        idx = jD.simulate_build(jax.random.PRNGKey(0), jnp.asarray(data), cfg, grid)
        _JAX[key] = (cfg, grid, idx, jp.make_family(jax.random.PRNGKey(0), data.shape[1], cfg))
    return _JAX[key]


def _jax_grid(kw: dict, nu: int, p: int, data: np.ndarray, q: np.ndarray, replication: int):
    """JAX's routed grid answer (with stats), its plan and its family."""
    cfg, grid, idx, family = _jax_index(kw, nu, p, data)
    plan = jr.make_plan(idx, cfg, grid, replication=replication)
    res, stats = jD.grid_query(idx, jnp.asarray(data), jnp.asarray(q), cfg, grid, plan=plan, return_stats=True)
    return res, stats, plan, family


def _assert_topk(res, ref_d, ref_i, data, q):
    pts, qt = torch.as_tensor(data), torch.as_tensor(q)
    why = ttopk.topk_mismatch(
        res.knn_dist, res.knn_idx, torch.as_tensor(np.asarray(ref_d)), torch.as_tensor(np.asarray(ref_i)),
        lambda rows, idx: (pts[idx.long()] - qt[rows]).abs().sum(-1), rtol=RTOL, atol=ATOL,
    )
    assert why is None, why


def _same(a, b):
    for f in ("knn_dist", "knn_idx", "comparisons", "compaction_overflow"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


ROUTED = [
    pytest.param({}, 4, 2, 1, id="4x2-r1"),
    pytest.param({}, 4, 2, 2, id="4x2-r2"),
    pytest.param(dict(multiprobe=2), 4, 2, 2, id="4x2-r2-multiprobe"),
]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("kw,nu,p,replication", ROUTED)
def test_routed_grid_equals_broadcast_and_jax(backend, kw, nu, p, replication):
    data = _clustered()
    q = (data[:16] + 0.001 * np.random.default_rng(9).standard_normal((16, 12))).astype(np.float32)
    jres, jstats, jplan, family = _jax_grid(kw, nu, p, data, q, replication)
    cfg = api.make_config(**_base(**kw), backend=backend)
    routed = api.build(0, data, cfg, api.grid(nu, p, replication=replication, routed=True), device="cpu",
                       params=family)
    broadcast = api.build(0, data, cfg, api.grid(nu, p), device="cpu", params=family)
    res, stats = routed.query_with_stats(q)
    bres = broadcast.query(q)
    _same(res, bres)
    # the router masked real work out only where the cell scanned nothing
    assert not bool((~res.routed & (bres.comparisons > 0)).any())
    assert res.routed_frac < 1.0
    # a with_routing handle over the broadcast build answers the same
    _same(broadcast.with_routing(replication=replication).query(q), res)
    # against JAX: the plan, the counters, the stats and the top-k
    plan = routed.plan
    np.testing.assert_array_equal(_np(plan.occupancy), np.asarray(jplan.occupancy))
    np.testing.assert_array_equal(plan.heat, jplan.heat)
    np.testing.assert_array_equal(plan.replicas, jplan.replicas)
    for f in ("comparisons", "compaction_overflow", "routed"):
        np.testing.assert_array_equal(_np(getattr(res, f)), np.asarray(getattr(jres, f)), err_msg=f)
    np.testing.assert_array_equal(stats.routed, jstats.routed)
    np.testing.assert_array_equal(stats.scores, jstats.scores)
    np.testing.assert_array_equal(stats.device_load, jstats.device_load)
    assert stats.payload == jstats.payload
    _assert_topk(res, jres.knn_dist, jres.knn_idx, data, q)


def test_routed_respects_drop_mask_and_degrades_with_max_cells():
    data = _clustered()
    q = data[:16]
    kw = dict(nu=4, p=2)
    jcfg, jgrid, jidx, family = _jax_index({}, 4, 2, data)
    cfg = api.make_config(**_base(), backend="cuda")
    routed = api.build(0, data, cfg, api.grid(**kw, routed=True, degrade=((1e9, None), (0.0, 2))),
                       device="cpu", params=family)
    broadcast = api.build(0, data, cfg, api.grid(**kw), device="cpu", params=family)
    drop = torch.tensor([False, False, True, False])
    a, b = routed.query(q, drop_mask=drop), broadcast.query(q, drop_mask=drop)
    assert torch.equal(a.knn_idx, b.knn_idx) and torch.equal(a.knn_dist, b.knn_dist)
    # deadline degradation: at most 2 cells a query, self-hit kept, work shrinks
    full = broadcast.query(q)
    capped = routed.query(q, budget=0.01)
    assert torch.equal(capped.routed, routed.query(q, max_cells=2).routed)
    assert bool((capped.routed.sum(dim=(0, 1)) <= 2).all())
    assert capped.knn_idx[:, 0].tolist() == list(range(16))
    assert bool((capped.comparisons <= full.comparisons).all())
    assert bool((capped.knn_dist.diff(dim=-1) >= 0).all())
    assert torch.equal(capped.knn_idx >= 0, torch.isfinite(capped.knn_dist))
    # against JAX's degraded routing on the same plan
    jres = jD.grid_query(jidx, jnp.asarray(data), jnp.asarray(q), jcfg, jgrid,
                         plan=jr.make_plan(jidx, jcfg, jgrid), max_cells=2)
    np.testing.assert_array_equal(_np(capped.routed), np.asarray(jres.routed))
    np.testing.assert_array_equal(_np(capped.comparisons), np.asarray(jres.comparisons))
    _assert_topk(capped, jres.knn_dist, jres.knn_idx, data, q)


def test_routing_refusals():
    cfg = api.make_config(**_base())
    data = _clustered(n=64)
    plain = api.build(0, data, cfg, api.grid(2, 2), device="cpu")
    with pytest.raises(api.ConfigError, match="max_cells requires a routed"):
        plain.query(data[:2], max_cells=1)
    with pytest.raises(api.ConfigError, match="degrade levels"):
        plain.query(data[:2], budget=0.1)
    with pytest.raises(api.ConfigError, match="replication"):
        api.Deployment(kind="grid", nu=2, p=2, replication=2)
    with pytest.raises(ValueError, match="routing plan"):
        tD.grid_query(plain.pipeline_index, plain._state["data"], torch.as_tensor(data[:2]), cfg, plain.grid,
                      return_stats=True)
