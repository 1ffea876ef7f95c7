"""The port's fault tolerance and elastic operations against the JAX
package's, under the same seeded chaos schedules (DESIGN.md §14).

The scenarios are those of ``tests/test_chaos.py`` and the seeded cores of
``tests/test_property_elastic.py``. Each JAX cluster is built once per
module by ``tests/chaos.py``'s ``make_cluster``; the port's twin gets the
same data, queries and hash family (``params.from_jax_params``). The
harness below is the port's own copy of ``tests/chaos.py``'s schedules and
runner (simulated clocks, seeded jitter); it drives both packages' elastic
wrappers with the same events, and every ``TickReport``, epoch, failover
and lost cell, migrated-cell count and elastic counter must be equal. The
port's exact and failover answers equal its healthy answer bit for bit;
its healthy and degraded answers equal JAX's in every counter and, tie-aware,
in the top-k (``core.topk.topk_mismatch``).
"""
from __future__ import annotations

import bisect
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import chaos as jchaos
from repro import obs as jobs
from repro.core import pipeline as jp
from repro.runtime import elastic as jelastic
from repro_torch import api, params
from repro_torch import obs as tobs
from repro_torch.core import pipeline as tp
from repro_torch.core import routing as tr
from repro_torch.core import topk as ttopk
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import ft

CPU = torch.device("cpu")
RTOL = ATOL = 1e-5
# the elastic layer's own metrics, and the answer counters they ride on
COUNTERS = ("dslsh_failovers_total", "dslsh_degraded_queries_total", "dslsh_rebalances_total",
            "dslsh_cells_migrated_total", "dslsh_epoch", "dslsh_replicas", "dslsh_comparisons_total",
            "dslsh_routed_queries_per_cell_total", "dslsh_compaction_overflow_total")


def _np(a) -> np.ndarray:
    return np.array(a.cpu() if isinstance(a, torch.Tensor) else a)


# ------------------------------------------------------- the port's harness


@dataclasses.dataclass
class Cluster:
    """One deployed grid under chaos: the handle, its healthy answer and
    the elastic wrapper every scenario drives (either package)."""

    index: object
    healthy: object
    elastic: object
    queries: np.ndarray

    @property
    def plan(self):
        """The routing plan of the build-time epoch."""
        return self.index.plan

    def cell_devices(self, j: int, c: int) -> list[int]:
        """Logical devices hosting cell (j, c) in the build-time epoch."""
        return [int(d) for d in self.plan.cell_device[j, c] if d >= 0]

    def replicated_cell(self) -> tuple:
        """The first cell the heat plan gave >= 2 replicas."""
        reps = self.plan.replicas
        cells = [(j, c) for j in range(reps.shape[0]) for c in range(reps.shape[1]) if int(reps[j, c]) >= 2]
        assert cells, "plan placed no replicas — build with replication>=2"
        return cells[0]


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: at ``t``, ``device`` is killed or revived."""

    t: float
    kind: str  # "kill" | "revive"
    device: int


class ChaosSchedule:
    """A sorted, deterministic fault timeline."""

    def __init__(self, events=()):
        self.events = sorted(events, key=lambda e: (e.t, e.device))

    def due(self, t0: float, t1: float) -> list[ChaosEvent]:
        """Events with ``t0 < t <= t1``."""
        ts = [e.t for e in self.events]
        return self.events[bisect.bisect_right(ts, t0): bisect.bisect_right(ts, t1)]

    @classmethod
    def kill_device(cls, device: int, t: float) -> "ChaosSchedule":
        return cls([ChaosEvent(t, "kill", device)])

    @classmethod
    def kill_cell(cls, cluster: Cluster, cell, t: float) -> "ChaosSchedule":
        return cls([ChaosEvent(t, "kill", d) for d in cluster.cell_devices(*cell)])

    @classmethod
    def flapping_node(cls, device: int, t0: float, period: float, flaps: int, seed: int = 0) -> "ChaosSchedule":
        """Kill/revive ``device`` every ``period`` (± seeded jitter <= 10%)."""
        rng = np.random.default_rng(seed)
        events, t = [], t0
        for _ in range(flaps):
            events.append(ChaosEvent(t, "kill", device))
            t += period / 2 * (1 + 0.1 * float(rng.uniform(-1, 1)))
            events.append(ChaosEvent(t, "revive", device))
            t += period / 2 * (1 + 0.1 * float(rng.uniform(-1, 1)))
        return cls(events)


def delayed_heartbeat(cluster: Cluster, device: int, delay_s: float):
    """Beats for ``device`` stamped ``delay_s`` late: alive, but looks down."""

    def beat(dev: int, now: float):
        cluster.elastic.beat(dev, t=now - delay_s if dev == device else now)

    return beat


@dataclasses.dataclass
class StepRecord:
    t: float
    epoch: int
    dead: tuple
    result: object  # ElasticQueryResult
    report: object  # TickReport


class ChaosRunner:
    """Per step: apply due events, beat live devices, query, tick; an epoch
    swap clears the dead set (migration placed the cells on fresh hosts)."""

    def __init__(self, cluster: Cluster, controller, schedule: ChaosSchedule, *, dt: float = 0.5, beat_fn=None):
        self.cluster, self.controller, self.schedule = cluster, controller, schedule
        self.dt, self.beat_fn = dt, beat_fn
        self.dead: set[int] = set()
        self.records: list[StepRecord] = []
        self._t = 0.0
        self._epoch = cluster.elastic.epoch.n

    def step(self) -> StepRecord:
        el = self.cluster.elastic
        t0, self._t = self._t, self._t + self.dt
        for ev in self.schedule.due(t0, self._t):
            (self.dead.add if ev.kind == "kill" else self.dead.discard)(ev.device)
        for dev in range(el.n_devices):
            if dev not in self.dead:
                if self.beat_fn is None:
                    el.beat(dev, t=self._t)
                else:
                    self.beat_fn(dev, self._t)
        result = el.query(self.cluster.queries, now=self._t)
        report = self.controller.tick(now=self._t)
        if report.epoch != self._epoch:
            self._epoch = report.epoch
            self.dead.clear()
        rec = StepRecord(self._t, report.epoch, tuple(sorted(self.dead)), result, report)
        self.records.append(rec)
        return rec

    def run(self, steps: int) -> list[StepRecord]:
        for _ in range(steps):
            self.step()
        return self.records


def mid_migration_kill(cluster: Cluster, controller, *, at_phase: str, device: int, probe=None) -> list[str]:
    """An ``on_phase`` hook that expires ``device`` at ``at_phase`` and runs
    ``probe(phase)`` at every phase; returns the phases seen."""
    seen: list[str] = []

    def hook(phase: str) -> None:
        seen.append(phase)
        if phase == at_phase:
            cluster.elastic.monitor.last_beat.pop(device, None)
        if probe is not None:
            probe(phase)

    controller.on_phase = hook
    return seen


# ------------------------------------------------------ both packages' clusters

_BUILT: dict = {}


def _built(seed: int, nu: int = 2, p: int = 2, replication: int = 2, n: int = 256):
    """The JAX cluster from ``tests/chaos.py`` and the port's twin over the
    same data, queries and family, each built once per module."""
    key = (seed, nu, p, replication, n)
    if key not in _BUILT:
        jcl = jchaos.make_cluster(seed=seed, nu=nu, p=p, replication=replication, n=n)
        data = np.array(jcl.data, np.float32)
        family = params.from_jax_params(*jp.make_family(jax.random.PRNGKey(seed), data.shape[1], jcl.cfg), CPU)
        kw = {f.name: getattr(jcl.cfg, f.name) for f in dataclasses.fields(jcl.cfg)}
        cfg = tp.SLSHConfig.compose(**{**kw, "backend": "torch", "interpret": None})
        tidx = api.build(seed, data, cfg, api.grid(nu=nu, p=p, replication=replication, routed=True),
                         device="cpu", params=family)
        q = np.array(jcl.queries, np.float32)
        thealthy = tidx.query(q)
        _same_answer(thealthy, jcl.healthy, data, q)
        np.testing.assert_array_equal(tidx.plan.cell_device, jcl.plan.cell_device)
        _BUILT[key] = (jcl, tidx, thealthy, data, q)
    return _BUILT[key]


def _pair(seed: int, *, obs: bool = False, deadline_s: float = 1.0, **kw):
    """Fresh elastic wrappers over the module's JAX and port indexes, each
    with its own obs bundle (or none)."""
    jcl, tidx, thealthy, data, q = _built(seed, **kw)
    jo, to = (jobs.Obs(trace=False), tobs.Obs(trace=False)) if obs else (None, None)
    ji, ti = jcl.index.with_obs(jo), tidx.with_obs(to)
    j = Cluster(ji, jcl.healthy, jelastic.ElasticIndex(ji, deadline_s=deadline_s, now=0.0), np.asarray(jcl.queries))
    t = Cluster(ti, thealthy, telastic.ElasticIndex(ti, deadline_s=deadline_s, now=0.0), q)
    return j, t, (jo, to), data


def _same_answer(res_t, res_j, data, q):
    """The port's answer equals JAX's: counters exactly, top-k tie-aware."""
    for f in ("comparisons", "compaction_overflow", "routed"):
        np.testing.assert_array_equal(_np(getattr(res_t, f)), _np(getattr(res_j, f)), err_msg=f)
    pts, qt = torch.as_tensor(data), torch.as_tensor(q)
    why = ttopk.topk_mismatch(
        res_t.knn_dist, res_t.knn_idx, torch.as_tensor(_np(res_j.knn_dist)), torch.as_tensor(_np(res_j.knn_idx)),
        lambda rows, idx: (pts[idx.long()] - qt[rows]).abs().sum(-1), rtol=RTOL, atol=ATOL,
    )
    assert why is None, why


def _bit_exact(result, healthy):
    res = result.result if hasattr(result, "result") else result
    for f in ("knn_dist", "knn_idx", "comparisons", "compaction_overflow", "routed"):
        assert torch.equal(getattr(res, f), getattr(healthy, f)), f


def _same_report(a, b):
    for f in a._fields:
        va, vb = getattr(a, f), getattr(b, f)
        if f == "replicas":
            np.testing.assert_array_equal(_np(va), _np(vb))
        else:
            assert va == vb, (f, va, vb)


def _same_records(rt: list, rj: list, data, q):
    """Both packages' runs step by step: the same reports, epochs, dead
    sets, failover and lost cells, and the same answers."""
    assert len(rt) == len(rj)
    for a, b in zip(rt, rj):
        assert (a.t, a.epoch, a.dead) == (b.t, b.epoch, b.dead)
        assert (a.result.epoch, a.result.failover_cells, a.result.lost_cells, a.result.degraded) == (
            b.result.epoch, b.result.failover_cells, b.result.lost_cells, b.result.degraded)
        _same_report(a.report, b.report)
        _same_answer(a.result.result, b.result.result, data, q)


def _same_counters(jo, to):
    js, ts = jo.snapshot(), to.snapshot()
    for name in COUNTERS:
        assert (name in ts) == (name in js), name
        if name in js:
            assert ts[name]["values"] == js[name]["values"], name


def _controller(mod, cl, **kw):
    return mod.ElasticController(cl.elastic, mod.ElasticConfig(deadline_s=1.0, **kw))


# ---------------------------------------------------------------- scenarios


def test_kill_replicated_cell_bit_exact_as_jax():
    j, t, (jo, to), data = _pair(3, obs=True)
    victim_cell = t.replicated_cell()
    assert victim_cell == j.replicated_cell()
    victim = t.cell_devices(*victim_cell)[0]
    sched = ChaosSchedule.kill_device(victim, t=1.0)
    runs = [ChaosRunner(cl, _controller(mod, cl, repair_ticks=99, scale_ticks=99), sched, dt=0.5).run(8)
            for cl, mod in ((t, telastic), (j, jelastic))]
    _same_records(*runs, data, t.queries)
    for rec in runs[0]:
        _bit_exact(rec.result, t.healthy)
        assert not rec.result.degraded
    failovers = [r for r in runs[0] if victim_cell in r.result.failover_cells]
    assert failovers
    jj, cc = victim_cell
    assert to.snapshot()["dslsh_failovers_total"]["values"][f'cell="{jj}/{cc}"'] == len(failovers)
    _same_counters(jo, to)


def test_kill_unreplicated_cell_flagged_as_jax():
    j, t, (jo, to), data = _pair(4, obs=True, replication=1)
    victim_cell = (0, 1)
    runs = [ChaosRunner(cl, _controller(mod, cl, repair_ticks=99, scale_ticks=99),
                        ChaosSchedule.kill_cell(cl, victim_cell, t=1.0), dt=0.5).run(6)
            for cl, mod in ((t, telastic), (j, jelastic))]
    _same_records(*runs, data, t.queries)
    degraded = [r for r in runs[0] if r.result.degraded]
    assert degraded
    for rec in degraded:
        res = rec.result.result
        assert victim_cell in rec.result.lost_cells
        assert not bool(res.routed[victim_cell].any())  # flagged off, never silent
        assert res.routed_frac < t.healthy.routed_frac
    _bit_exact(runs[0][0].result, t.healthy)
    assert to.snapshot()["dslsh_degraded_queries_total"]["values"][""] == len(degraded)
    _same_counters(jo, to)


def test_kill_during_migration_old_epoch_serves_as_jax(tmp_path):
    j, t, _, data = _pair(3)
    seen_by = {}
    for name, cl, mod in (("t", t, telastic), ("j", j, jelastic)):
        ctl = _controller(mod, cl)
        ctl._workdir = str(tmp_path / name)
        probed = []

        def probe(phase, cl=cl, probed=probed):
            r = cl.elastic.query(cl.queries, now=5.0)
            probed.append((phase, r.epoch, r.degraded, r.failover_cells))

        seen = mid_migration_kill(cl, ctl, at_phase="load", device=cl.cell_devices(0, 0)[0], probe=probe)
        for d in range(cl.elastic.n_devices):
            cl.elastic.beat(d, t=5.0)
        epoch, migrated = ctl.rebalance(cl.plan.replicas.copy(), now=5.0)
        after = cl.elastic.query(cl.queries, now=5.1)
        seen_by[name] = (seen, probed, epoch.n, migrated, after.epoch, after.degraded, after.failover_cells)
        if name == "t":
            assert seen == ["restore", "save", "load", "swap"]
            assert [p[:2] for p in probed] == [("restore", 0), ("save", 0), ("load", 0), ("swap", 1)]
            _bit_exact(after, t.healthy)
    assert seen_by["t"] == seen_by["j"]


def test_flapping_node_no_replica_churn_as_jax():
    j, t, _, data = _pair(3)
    flapper = t.cell_devices(*t.replicated_cell())[0]
    sched = ChaosSchedule.flapping_node(flapper, t0=1.0, period=4.0, flaps=5, seed=6)
    runs = [ChaosRunner(cl, _controller(mod, cl, repair_ticks=3, scale_ticks=99), sched, dt=1.0).run(20)
            for cl, mod in ((t, telastic), (j, jelastic))]
    _same_records(*runs, data, t.queries)
    assert all(not r.report.rebalanced for r in runs[0]) and t.elastic.epoch.n == 0
    assert any(flapper in r.report.down_devices for r in runs[0])
    for r in runs[0]:
        _bit_exact(r.result, t.healthy)


def test_delayed_heartbeat_transient_failover_no_repair_as_jax():
    j, t, _, data = _pair(3)
    laggard = t.cell_devices(*t.replicated_cell())[0]
    runs = [ChaosRunner(cl, _controller(mod, cl, repair_ticks=5, scale_ticks=99), ChaosSchedule(), dt=1.0,
                        beat_fn=delayed_heartbeat(cl, laggard, delay_s=1.5)).run(4)
            for cl, mod in ((t, telastic), (j, jelastic))]
    _same_records(*runs, data, t.queries)
    assert any(laggard in r.report.down_devices for r in runs[0])
    assert all(not r.report.rebalanced for r in runs[0])
    for r in runs[0]:
        _bit_exact(r.result, t.healthy)


def test_sustained_kill_repairs_to_clean_epoch_as_jax(tmp_path):
    j, t, (jo, to), data = _pair(3, obs=True)
    victim = t.cell_devices(*t.replicated_cell())[0]
    runs = []
    for name, cl, mod in (("t", t, telastic), ("j", j, jelastic)):
        ctl = _controller(mod, cl, repair_ticks=2, scale_ticks=99)
        ctl._workdir = str(tmp_path / name)
        runs.append(ChaosRunner(cl, ctl, ChaosSchedule.kill_device(victim, t=1.0), dt=1.0).run(8))
    _same_records(*runs, data, t.queries)
    swaps = [r for r in runs[0] if r.report.rebalanced]
    assert len(swaps) == 1 and swaps[0].report.migrated_cells >= 1
    tail = runs[0][-1]
    assert tail.epoch == t.elastic.epoch.n == 1
    assert tail.result.failover_cells == () and not tail.result.degraded
    _bit_exact(tail.result, t.healthy)
    assert to.snapshot()["dslsh_rebalances_total"]["values"][""] == 1.0
    _same_counters(jo, to)


def test_lost_cell_restored_on_repair_as_jax(tmp_path):
    j, t, _, data = _pair(4, replication=1)
    runs = []
    for name, cl, mod in (("t", t, telastic), ("j", j, jelastic)):
        ctl = _controller(mod, cl, repair_ticks=2, scale_ticks=99)
        ctl._workdir = str(tmp_path / name)
        runs.append(ChaosRunner(cl, ctl, ChaosSchedule.kill_cell(cl, (1, 0), t=1.0), dt=1.0).run(6))
    _same_records(*runs, data, t.queries)
    assert any(r.result.degraded for r in runs[0])
    swaps = [r for r in runs[0] if r.report.rebalanced]
    assert swaps and 1 in swaps[0].report.repaired_nodes
    assert not runs[0][-1].result.degraded
    _bit_exact(runs[0][-1].result, t.healthy)


def test_fresh_monitor_grace_no_phantom_outage():
    mon = ft.HeartbeatMonitor(4, deadline_s=1.0, start=0.0)
    assert not mon.drop_mask(now=0.9).any()
    assert mon.drop_mask(now=1.5).all()
    _, t, _, _ = _pair(3)
    rep = _controller(telastic, t, repair_ticks=1, scale_ticks=99).tick(now=0.5)
    assert rep.down_devices == () and not rep.rebalanced


def test_restore_cells_rebuilds_only_the_failed_nodes(monkeypatch):
    """``elastic_restore_cells`` builds exactly ``p`` cells per failed node
    from their own params, reuses the survivors' tensors and never builds
    from scratch; the restored index answers bit-exactly."""
    j, t, _, data = _pair(11, nu=3, p=2, replication=1, n=288)

    def boom(*a, **kw):  # pragma: no cover - failure path
        raise AssertionError("restore must not rebuild from scratch")

    monkeypatch.setattr(api, "build", boom)
    monkeypatch.setattr("repro_torch.core.distributed.simulate_build", boom)
    calls = []
    real = tp.build_from_params

    def counting(data_local, outer, inner, cfg):
        calls.append((data_local.data_ptr(), outer.dims.data_ptr()))
        return real(data_local, outer, inner, cfg)

    monkeypatch.setattr(tp, "build_from_params", counting)
    old = t.index.pipeline_index
    restored = ft.elastic_restore_cells(t.index, [1])
    assert len(calls) == 2  # p cells of one node
    assert {c[1] for c in calls} == {old[2].outer_params.dims.data_ptr(), old[3].outer_params.dims.data_ptr()}
    restored2 = ft.elastic_restore_cells(restored, [0, 2])
    assert len(calls) == 2 + 2 * 2
    new = restored.pipeline_index
    for s in (0, 1, 4, 5):  # survivors: the very same tensors
        assert new[s].outer.sorted_keys.data_ptr() == old[s].outer.sorted_keys.data_ptr()
        assert new[s].inner_keys.data_ptr() == old[s].inner_keys.data_ptr()
    for s in (2, 3):  # rebuilt, equal
        assert new[s].outer.sorted_keys.data_ptr() != old[s].outer.sorted_keys.data_ptr()
        assert torch.equal(new[s].outer.sorted_keys, old[s].outer.sorted_keys)
    for idx in (restored, restored2):
        _bit_exact(idx.query(t.queries), t.healthy)
    assert t.index.pipeline_index is old  # the input handle is unchanged


def test_elastic_reshard_index_reuses_with_handle():
    j, t, _, data = _pair(11, nu=3, p=2, replication=1, n=288)
    labels = np.arange(data.shape[0])
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        idx2, labs, n_real = ft.elastic_reshard_index(None, data, labels, t.index.cfg, t.index, [2])
    assert idx2.deploy.nu == 3 and n_real == data.shape[0] and labs.shape == (data.shape[0],)
    assert torch.equal(idx2.query(t.queries).knn_idx, t.healthy.knn_idx)
    family = params.from_jax_params(*jp.make_family(jax.random.PRNGKey(11), data.shape[1], j.index.cfg), CPU)
    with pytest.warns(DeprecationWarning):
        idx3, labs3, _ = ft.elastic_reshard_index(family, data, labels, t.index.cfg, t.index.deploy, [2],
                                                  device="cpu")
    assert idx3.deploy.nu == 2 and idx3.deploy.cells % 2 == 0
    grid, cells, pts, labs4, n4 = ft.elastic_reshard_dslsh(family, data, labels, t.index.cfg, t.index.grid, [2],
                                                            device="cpu")
    assert (grid.nu, grid.p, len(cells), n4) == (2, 2, 4, data.shape[0])
    assert all(torch.equal(a.outer.sorted_keys, b.outer.sorted_keys) for a, b in zip(cells, idx3.pipeline_index))


def test_drop_cells_requires_grid_and_elastic_requires_routed_grid():
    _, t, _, data = _pair(3)
    cfg = t.index.cfg
    single = api.build(0, data[:128], cfg, api.single(), device="cpu")
    with pytest.raises(ValueError):
        single.query(data[:4], drop_cells=np.zeros((1, 1), bool))
    plain = api.build(0, data[:128], cfg, api.grid(nu=2, p=2), device="cpu")
    with pytest.raises(ValueError):
        telastic.ElasticIndex(plain)


# ------------------------------------------ seeded cores of the property sweep


@pytest.mark.parametrize("seed,replication", [(3, 2), (4, 1)])
def test_rebalance_bit_exact_seeded_as_jax(seed, replication, tmp_path):
    """Any replica map: the new epoch answers bit-exactly, and both packages
    publish the same plan and count the same migrated cells."""
    j, t, _, data = _pair(seed, replication=replication)
    target = np.random.default_rng(seed).integers(1, 4, size=(2, 2)).astype(np.int32)
    out = {}
    for name, cl, mod in (("t", t, telastic), ("j", j, jelastic)):
        ctl = _controller(mod, cl)
        ctl._workdir = str(tmp_path / name)
        epoch, migrated = ctl.rebalance(target, now=0.5)
        out[name] = (epoch.n, migrated, epoch.index.plan.replicas.tolist(), epoch.index.plan.cell_device.tolist())
    assert out["t"] == out["j"]
    res = t.elastic.query(t.queries, now=0.6)
    assert res.epoch == 1 and res.failover_cells == () and not res.degraded
    _bit_exact(res, t.healthy)
    np.testing.assert_array_equal(t.elastic.index.plan.replicas, target)


def test_migration_roundtrip_composes_seeded(tmp_path):
    """save → load → replan, twice over, stays bit-exact; the moved handle's
    plan deals ``sum(replicas)`` devices."""
    _, t, _, _ = _pair(3)
    rng = np.random.default_rng(5)
    hop = t.index
    for i in range(2):
        path = str(tmp_path / f"hop{i}")
        hop.save(path)
        moved = api.load(path, device="cpu")
        replicas = rng.integers(1, 4, size=(2, 2)).astype(np.int32)
        plan = tr.replan(moved.plan, replicas)
        deploy = dataclasses.replace(moved.deploy, replication=int(replicas.max()))
        hop = api.Index(deploy, moved.cfg, {**moved._state, "plan": plan})
        _bit_exact(hop.query(t.queries), t.healthy)
        assert plan.n_devices == int(replicas.sum())


def test_rebalance_during_load_accumulation_seeded(tmp_path):
    """A rebalance mid-stream keeps answers bit-exact, and the load the
    controller drains matches JAX's before and counts on after it."""
    j, t, _, data = _pair(4, replication=1)
    loads = {}
    for name, cl in (("t", t), ("j", j)):
        for i in range(3):
            r = cl.elastic.query(cl.queries, now=0.1 * i)
        loads[name] = cl.elastic.take_load()
        if name == "t":
            _bit_exact(r, t.healthy)
    np.testing.assert_array_equal(loads["t"], loads["j"])
    ctl = _controller(telastic, t)
    ctl._workdir = str(tmp_path)
    ctl.rebalance(np.full((2, 2), 2, np.int32), now=0.5)
    for i in range(3):
        _bit_exact(t.elastic.query(t.queries, now=0.6 + 0.1 * i), t.healthy)
    load = t.elastic.take_load()
    np.testing.assert_array_equal(load, loads["t"])  # the same routing on the new epoch


def test_observe_event_and_retry_as_jax():
    """The controller's latency signal (EMA and histogram) and the retry
    wrapper behave as the JAX package's."""
    from repro.runtime import ft as jft

    j, t, (jo, to), _ = _pair(3, obs=True)
    ctls = [_controller(mod, cl) for cl, mod in ((t, telastic), (j, jelastic))]
    for lat in (0.02, 0.5, 0.07):
        ev = dataclasses.make_dataclass("Ev", [("latency_s", float)])(lat)
        for ctl in ctls:
            ctl.observe_event(ev)
    assert ctls[0]._lat_ema == pytest.approx(ctls[1]._lat_ema)
    name = "dslsh_elastic_event_latency_seconds"
    assert to.snapshot()[name] == jo.snapshot()[name]
    for mod in (ft, jft):
        calls = []

        def flaky(x, calls=calls):
            calls.append(x)
            if len(calls) < 3:
                raise OSError("transient")
            return 2 * x

        assert mod.retry(flaky, attempts=3, backoff_s=0.0)(21) == 42 and len(calls) == 3
        with pytest.raises(OSError):
            mod.retry(lambda: (_ for _ in ()).throw(OSError("down")), attempts=2, backoff_s=0.0)()
