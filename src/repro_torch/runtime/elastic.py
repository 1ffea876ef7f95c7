"""Elastic operations: failover serving, live migration, and the controller
(the counterpart of ``repro.runtime.elastic``).

The paper deploys DSLSH across 40 processors and "prioritizes latency over
throughput"; a processor going away must therefore cost a bounded, *flagged*
amount of answer quality — never a silent wrong answer — and capacity must
follow load while queries keep flowing. This module closes that loop
(ROADMAP "Elastic operations", DESIGN.md §14):

* :class:`ElasticIndex` — a serving wrapper around a **routed grid**
  ``repro_torch.dslsh`` handle. Every query snapshots the current *epoch* (index +
  routing plan + :class:`~repro_torch.runtime.ft.HeartbeatMonitor`) with a single
  reference read — the RCU pattern: readers never lock, writers publish a
  whole new epoch atomically. Per-cell liveness comes from
  ``routing.live_replicas`` over the monitor's ``drop_mask``:

  - a cell with **some replicas down but ≥ 1 alive** is served by a
    surviving replica — the result is **bit-exact** (the replicas are
    copies; only the per-device load accounting shifts). The cell is
    reported in ``failover_cells`` and ``dslsh_failovers_total`` counts it.
  - a cell with **zero live replicas** is excluded via the ``drop_cells``
    channel of :meth:`repro_torch.api.Index.query` — the result is degraded but
    **flagged**: the cell's rows flip off in ``res.routed`` (visible as
    ``routed_frac`` / ``overflow_cells``), and
    ``dslsh_degraded_queries_total`` counts the batch.

* :class:`ElasticController` — the reconciliation loop. Each
  :meth:`~ElasticController.tick` reads heartbeat liveness and the
  accumulated per-cell routed load (the same ``queries_per_cell`` signal the
  §10 plan balances, plus any :meth:`~ElasticController.observe_event`
  latencies), applies **hysteresis** (a node must stay down / a cell must
  stay hot for ``repair_ticks`` / ``scale_ticks`` consecutive ticks — a
  flapping node never triggers churn), and when action is due runs
  :meth:`~ElasticController.rebalance`: restore any fully-lost cells from
  the durable store (:func:`repro_torch.runtime.ft.elastic_restore_cells`),
  migrate the index with an ``Index.save`` → ``load`` round-trip (the
  moved copy on the replacement hosts), attach the new replica placement
  (``routing.replan``), and publish it all as the next epoch. In-flight
  queries keep reading the old epoch until the swap — they never observe a
  half-moved cell.

Everything emits through the existing obs layer: spans
``elastic.tick`` / ``elastic.rebalance`` / ``elastic.failover``, counters
``dslsh_failovers_total`` / ``dslsh_cells_migrated_total`` /
``dslsh_degraded_queries_total`` / ``dslsh_rebalances_total``, gauges
``dslsh_replicas{cell}`` and ``dslsh_epoch``. All timing accepts ``now=``
for deterministic simulated clocks, so a chaos schedule replays exactly
(tests/test_torch_chaos.py). The migration's ``load`` lands the moved copy
on the device the serving index lives on.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import routing
from repro_torch.obs import clock
from repro_torch.runtime import ft


class Epoch(NamedTuple):
    """One immutable serving generation: readers snapshot it with a single
    reference read; :meth:`ElasticController.rebalance` publishes the next
    one atomically (RCU — DESIGN.md §14)."""

    n: int  # generation counter (monotonic)
    index: object  # repro_torch.api.Index — routed grid handle
    monitor: ft.HeartbeatMonitor  # liveness over this epoch's devices


class ElasticQueryResult(NamedTuple):
    """One elastic query answer plus the failover story behind it."""

    result: object  # DistributedQueryResult — bit-exact unless degraded
    epoch: int  # Epoch.n the answer was served from
    failover_cells: tuple  # ((j, c), ...) served by a surviving replica
    lost_cells: tuple  # ((j, c), ...) with zero live replicas (flagged)

    @property
    def degraded(self) -> bool:
        """True iff some routed cell had zero live replicas — the result
        is then partial, and ``result.routed`` flags exactly which rows."""
        return bool(self.lost_cells)


class TickReport(NamedTuple):
    """What one :meth:`ElasticController.tick` saw and did."""

    epoch: int  # serving epoch after the tick
    down_devices: tuple  # devices past the heartbeat deadline this tick
    lost_cells: tuple  # ((j, c), ...) with zero live replicas
    hot_cells: tuple  # cells whose load crossed the hot threshold
    cold_cells: tuple  # cells whose load crossed the cold threshold
    rebalanced: bool  # did this tick publish a new epoch?
    repaired_nodes: tuple  # grid nodes whose cells were restored
    migrated_cells: int  # cells whose placement changed in the rebalance
    replicas: object  # (nu, p) replica counts now serving


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Controller knobs (all hysteresis is in *ticks*, not seconds, so the
    loop is deterministic under simulated clocks).

    ``repair_ticks`` — consecutive ticks a device must stay down before the
    controller treats the failure as permanent and rebalances; a node that
    flaps up/down each tick resets the counter and never triggers churn
    (tests/test_torch_chaos.py pins this).
    ``scale_ticks`` — same idea for load: a cell must stay hot/cold this
    many consecutive ticks before its replica count changes.
    ``hot_factor`` / ``cold_factor`` — a cell is hot when its routed load
    exceeds ``hot_factor ×`` the mean cell load, cold when below
    ``cold_factor ×`` mean (and it still holds more than ``r_min``
    replicas).
    ``workdir`` — where migration checkpoints land (one subdir per epoch);
    a temp dir is created lazily when unset.
    """

    deadline_s: float = 1.0
    repair_ticks: int = 3
    scale_ticks: int = 3
    hot_factor: float = 2.0
    cold_factor: float = 0.25
    r_min: int = 1
    r_max: int = 4
    workdir: str | None = None


def advance(epoch: Epoch, index) -> Epoch:
    """The next generation of ``epoch`` serving ``index`` (RCU publish).

    Pure bookkeeping for single-swap publishers outside the elastic
    controller — the §15 serving front end builds a streaming ingest
    delta aside and publishes it by assigning ``advance(epoch, new)``
    over the old reference; in-flight readers keep the epoch they
    snapshotted. The monitor (if any) carries over: liveness is about
    devices, which an ingest swap does not change.
    """
    return Epoch(epoch.n + 1, index, epoch.monitor)


def _fresh_monitor(
    n_devices: int, deadline_s: float, now: float | None
) -> ft.HeartbeatMonitor:
    """A monitor for a new epoch with every device registered live at the
    swap instant — migration lands the cells on (logically) fresh hosts, so
    each placement re-registers and earns a full deadline of grace."""
    t0 = clock.monotonic() if now is None else now
    mon = ft.HeartbeatMonitor(n_devices, deadline_s=deadline_s, start=t0)
    for dev in range(n_devices):
        mon.beat(dev, t=t0)
    return mon


class ElasticIndex:
    """Failover-serving wrapper around a routed grid ``repro_torch.dslsh``
    handle.

    Queries read the current :class:`Epoch` with one reference read, mask
    cells that have zero live replicas through the ``drop_cells`` channel
    (flagged degradation), and serve everything else bit-exactly — a cell
    whose replica died but has a survivor answers identically to the
    healthy index. Per-cell routed load accumulates host-side for the
    controller's hot/cold decisions (this syncs the routed mask per query;
    the elastic path is the controller-in-the-loop serving mode — use the
    raw handle where that sync is unacceptable).
    """

    def __init__(
        self,
        index,
        *,
        deadline_s: float = 1.0,
        now: float | None = None,
    ):
        from repro_torch.core import pipeline

        pipeline._require(
            index.deploy.kind == "grid" and index.plan is not None,
            "ElasticIndex serves a routed grid handle — build with"
            " dslsh.grid(..., routed=True) or call .with_routing()",
        )
        self.deadline_s = deadline_s
        self._epoch = Epoch(
            0, index, _fresh_monitor(index.plan.n_devices, deadline_s, now)
        )
        nu, p = index.deploy.nu, index.deploy.p
        self._load = np.zeros((nu, p), np.int64)

    # ------------------------------------------------------------- facts

    @property
    def epoch(self) -> Epoch:
        """The current serving epoch (snapshot this once per operation)."""
        return self._epoch

    @property
    def index(self):
        """The current epoch's underlying ``repro_torch.dslsh`` handle."""
        return self._epoch.index

    @property
    def monitor(self) -> ft.HeartbeatMonitor:
        """The current epoch's heartbeat monitor."""
        return self._epoch.monitor

    @property
    def n_devices(self) -> int:
        """Logical devices (replica placements) in the current epoch."""
        return self._epoch.index.plan.n_devices

    def beat(self, device: int, t: float | None = None) -> None:
        """Record a heartbeat for ``device`` in the current epoch."""
        self._epoch.monitor.beat(device, t=t)

    def take_load(self) -> np.ndarray:
        """Per-cell routed query counts accumulated since the last call
        (the controller drains this each tick)."""
        load, self._load = self._load, np.zeros_like(self._load)
        return load

    # ------------------------------------------------------------- query

    def query(
        self,
        queries,
        *,
        now: float | None = None,
        budget: float | None = None,
        max_cells: int | None = None,
    ) -> ElasticQueryResult:
        """Answer a batch through the current epoch with replica failover.

        Snapshots the epoch (RCU read), derives per-cell liveness from the
        heartbeat monitor, and serves: cells with a surviving replica are
        bit-exact, cells with none are dropped-and-flagged via
        ``drop_cells``. Emits an ``elastic.failover`` span and bumps
        ``dslsh_failovers_total{cell}`` when a cell is served by a
        surviving replica; bumps ``dslsh_degraded_queries_total`` when any
        routed cell was lost outright. ``budget`` / ``max_cells`` pass
        through to :meth:`repro_torch.api.Index.query`.
        """
        epoch = self._epoch  # RCU: one ref read; rebalance swaps the tuple
        plan = epoch.index.plan
        down = epoch.monitor.drop_mask(now)
        live = routing.live_replicas(plan, down)
        lost = live == 0
        failover = (live < plan.replicas) & ~lost

        res = epoch.index.query(
            queries, budget=budget, max_cells=max_cells, drop_cells=lost
        )
        routed = res.routed.cpu().numpy()  # (nu, p, Q) — syncs
        per_cell = routed.sum(axis=2)
        self._load += per_cell

        fo_cells = tuple(
            (int(j), int(c)) for j, c in zip(*np.nonzero(failover & (per_cell > 0)))
        )
        lost_cells = tuple((int(j), int(c)) for j, c in zip(*np.nonzero(lost)))
        ob = self._obs()
        if ob is not None and (fo_cells or lost_cells):
            with ob.activate():
                with ob.span(
                    "elastic.failover",
                    epoch=epoch.n,
                    failover_cells=len(fo_cells),
                    lost_cells=len(lost_cells),
                ):
                    pass
                m = ob.metrics
                if m is None:
                    return ElasticQueryResult(
                        res, epoch.n, fo_cells, lost_cells
                    )
                if fo_cells:
                    fo = m.counter(
                        "dslsh_failovers_total",
                        "cell-batches answered by a surviving replica"
                        " after a placement died (bit-exact failover)",
                    )
                    for j, c in fo_cells:
                        fo.labels(cell=f"{j}/{c}").inc()
                if lost_cells:
                    m.counter(
                        "dslsh_degraded_queries_total",
                        "query batches answered with ≥1 cell lost outright"
                        " — degraded and flagged via res.routed, never"
                        " silent",
                    ).inc()
        return ElasticQueryResult(res, epoch.n, fo_cells, lost_cells)

    # ---------------------------------------------------------- internal

    def _obs(self):
        """The wrapped handle's obs bundle, or the ambient one (or None)."""
        ob = self._epoch.index._obs
        if ob is None:
            ob = obs_mod.get_active()
        return ob if (ob is not None and ob.enabled) else None

    def _swap(self, epoch: Epoch) -> None:
        """Publish ``epoch`` atomically (single reference assignment); the
        load accumulator is re-shaped if the grid changed."""
        nu, p = epoch.index.deploy.nu, epoch.index.deploy.p
        if self._load.shape != (nu, p):
            self._load = np.zeros((nu, p), np.int64)
        self._epoch = epoch


@dataclasses.dataclass
class ElasticController:
    """The reconciliation loop over an :class:`ElasticIndex`.

    Call :meth:`tick` on a cadence (real or simulated). Each tick reads
    liveness and drained load, advances the hysteresis counters, and — when
    a failure is confirmed permanent or a cell's load has stayed hot/cold
    long enough — runs one :meth:`rebalance`. ``on_phase`` (if set) is
    called with ``"restore" | "save" | "load" | "swap"`` as the rebalance
    passes each phase — the chaos harness uses it to kill things
    mid-migration and prove the old epoch serves until the swap.
    """

    elastic: ElasticIndex
    cfg: ElasticConfig = dataclasses.field(default_factory=ElasticConfig)
    on_phase: Callable[[str], None] | None = None

    def __post_init__(self):
        self._down_ticks: dict[int, int] = {}
        self._hot_ticks: dict[tuple, int] = {}
        self._cold_ticks: dict[tuple, int] = {}
        self._seen_epoch = self.elastic.epoch.n
        self._lat_ema: float | None = None
        self._workdir: str | None = self.cfg.workdir

    # ------------------------------------------------------------ signals

    def observe_event(self, event) -> None:
        """Feed one stream/serving event (anything with ``latency_s`` —
        e.g. a :class:`repro_torch.stream.monitor.StreamEvent`): the latency
        lands in ``dslsh_elastic_event_latency_seconds`` and an EMA the
        tick report carries."""
        lat = float(event.latency_s)
        self._lat_ema = (
            lat if self._lat_ema is None else 0.9 * self._lat_ema + 0.1 * lat
        )
        ob = self.elastic._obs()
        if ob is not None and ob.metrics is not None:
            ob.metrics.histogram(
                "dslsh_elastic_event_latency_seconds",
                "per-event serving latency observed by the elastic"
                " controller",
            ).observe(lat)

    # --------------------------------------------------------------- tick

    def tick(self, now: float | None = None) -> TickReport:
        """One reconciliation pass: observe, apply hysteresis, maybe act.

        Reads the current epoch's heartbeat ``drop_mask`` and the load
        drained from the elastic handle; updates per-device down-streaks
        and per-cell hot/cold streaks; publishes ``dslsh_replicas{cell}``
        gauges. When a device's down-streak reaches ``repair_ticks`` or a
        cell's hot/cold streak reaches ``scale_ticks``, computes the target
        replica map and runs :meth:`rebalance` inside this tick's span.
        Returns the :class:`TickReport` of everything observed and done.
        """
        t = clock.monotonic() if now is None else now
        ob = self.elastic._obs()
        if ob is None:
            return self._tick_body(t, None)
        with ob.activate(), ob.span("elastic.tick", now=t):
            return self._tick_body(t, ob)

    def _tick_body(self, now: float, ob) -> TickReport:
        epoch = self.elastic.epoch
        plan = epoch.index.plan
        if epoch.n != self._seen_epoch:
            # new epoch = new device numbering; streaks restart
            self._down_ticks.clear()
            self._hot_ticks.clear()
            self._cold_ticks.clear()
            self._seen_epoch = epoch.n

        down = epoch.monitor.drop_mask(now)
        for dev in range(plan.n_devices):
            self._down_ticks[dev] = (
                self._down_ticks.get(dev, 0) + 1 if down[dev] else 0
            )
        live = routing.live_replicas(plan, down)
        lost = live == 0
        if ob is not None and ob.metrics is not None:
            g = ob.metrics.gauge(
                "dslsh_replicas",
                "live replicas per (node, core) cell this tick",
            )
            for j in range(live.shape[0]):
                for c in range(live.shape[1]):
                    g.labels(cell=f"{j}/{c}").set(float(live[j, c]))

        load = self.elastic.take_load()
        mean = float(load.mean())
        hot = (load > self.cfg.hot_factor * mean) if mean > 0 else np.zeros_like(lost)
        cold = (
            (load < self.cfg.cold_factor * mean) & (plan.replicas > self.cfg.r_min)
            if mean > 0
            else np.zeros_like(lost)
        )
        for j in range(live.shape[0]):
            for c in range(live.shape[1]):
                cell = (j, c)
                self._hot_ticks[cell] = (
                    self._hot_ticks.get(cell, 0) + 1 if hot[j, c] else 0
                )
                self._cold_ticks[cell] = (
                    self._cold_ticks.get(cell, 0) + 1 if cold[j, c] else 0
                )

        permanent = [
            d for d, k in self._down_ticks.items() if k >= self.cfg.repair_ticks
        ]
        grow = [
            cell
            for cell, k in self._hot_ticks.items()
            if k >= self.cfg.scale_ticks
            and plan.replicas[cell] < self.cfg.r_max
        ]
        shrink = [
            cell
            for cell, k in self._cold_ticks.items()
            if k >= self.cfg.scale_ticks
            and plan.replicas[cell] > self.cfg.r_min
        ]

        report_base = dict(
            down_devices=tuple(int(d) for d in np.nonzero(down)[0]),
            lost_cells=tuple(
                (int(j), int(c)) for j, c in zip(*np.nonzero(lost))
            ),
            hot_cells=tuple(grow),
            cold_cells=tuple(shrink),
        )
        if not permanent and not grow and not shrink:
            return TickReport(
                epoch=epoch.n, rebalanced=False, repaired_nodes=(),
                migrated_cells=0, replicas=plan.replicas.copy(),
                **report_base,
            )

        # confirmed action: permanent failures repair on their current
        # replica count (replacement hosts), hot/cold cells scale
        target = plan.replicas.copy()
        for cell in grow:
            target[cell] += 1
        for cell in shrink:
            target[cell] -= 1
        # cells ONLY reachable through permanently-dead devices must be
        # restored from the durable store before the move
        perm_down = np.zeros(plan.n_devices, bool)
        perm_down[permanent] = True
        perm_live = routing.live_replicas(plan, perm_down)
        lost_nodes = sorted({int(j) for j, _ in zip(*np.nonzero(perm_live == 0))})
        new_epoch, migrated = self.rebalance(
            target, lost_nodes=lost_nodes, dead_devices=permanent, now=now
        )
        for cell in grow:
            self._hot_ticks[cell] = 0
        for cell in shrink:
            self._cold_ticks[cell] = 0
        return TickReport(
            epoch=new_epoch.n, rebalanced=True,
            repaired_nodes=tuple(lost_nodes), migrated_cells=migrated,
            replicas=new_epoch.index.plan.replicas.copy(), **report_base,
        )

    # ---------------------------------------------------------- rebalance

    def rebalance(
        self,
        replicas,
        *,
        lost_nodes: list[int] | None = None,
        dead_devices: list[int] | None = None,
        now: float | None = None,
    ) -> tuple[Epoch, int]:
        """Migrate to a new replica map and publish it as the next epoch.

        Phases (each reported to ``on_phase``): **restore** — rebuild any
        fully-lost nodes' cells from the durable store
        (:func:`repro_torch.runtime.ft.elastic_restore_cells`); **save** /
        **load** — the ``Index.save`` → ``load`` round-trip is the
        migration primitive (the loaded handle is the moved copy on the
        replacement hosts); then attach ``routing.replan(replicas)`` and a
        fresh fully-registered monitor, and **swap** the epoch atomically.
        Queries in flight keep the old epoch throughout — they never see a
        half-moved cell. Returns ``(new_epoch, migrated_cells)``.
        """
        from repro_torch import api

        t = clock.monotonic() if now is None else now
        lost_nodes = list(lost_nodes or ())
        old = self.elastic.epoch
        ob = self.elastic._obs()
        span = (
            ob.span(
                "elastic.rebalance", epoch=old.n + 1,
                lost_nodes=len(lost_nodes),
            )
            if ob is not None
            else obs_mod.NULL_SPAN
        )
        with span:
            index = old.index
            if lost_nodes:
                index = ft.elastic_restore_cells(index, lost_nodes)
            self._phase("restore")

            path = os.path.join(self._ensure_workdir(), f"epoch{old.n + 1}")
            index.save(path)
            self._phase("save")
            loaded = api.load(path, device=index.device, obs=old.index._obs)
            self._phase("load")

            replicas = np.asarray(replicas, np.int32)
            new_plan = routing.replan(loaded.plan, replicas)
            deploy = dataclasses.replace(
                loaded.deploy, replication=int(replicas.max())
            )
            new_index = api.Index(
                deploy, loaded.cfg, {**loaded._state, "plan": new_plan},
                obs=old.index._obs,
            )
            if new_index.device.type == "cuda":
                torch.cuda.synchronize(new_index.device)

            migrated = _migrated_cells(
                old.index.plan, new_plan, lost_nodes, list(dead_devices or ())
            )
            monitor = _fresh_monitor(
                new_plan.n_devices, self.cfg.deadline_s, t
            )
            new_epoch = Epoch(old.n + 1, new_index, monitor)
            self.elastic._swap(new_epoch)
            self._seen_epoch = new_epoch.n
            self._down_ticks.clear()
            self._phase("swap")

            if ob is not None and ob.metrics is not None:
                m = ob.metrics
                m.counter(
                    "dslsh_cells_migrated_total",
                    "cells whose placement changed across an elastic"
                    " rebalance (includes restored cells)",
                ).inc(migrated)
                m.counter(
                    "dslsh_rebalances_total",
                    "elastic rebalances published (epoch swaps)",
                ).inc()
                m.gauge(
                    "dslsh_epoch", "current elastic serving epoch"
                ).set(float(new_epoch.n))
        return new_epoch, migrated

    # ---------------------------------------------------------- internal

    def _phase(self, name: str) -> None:
        if self.on_phase is not None:
            self.on_phase(name)

    def _ensure_workdir(self) -> str:
        if self._workdir is None:
            self._workdir = tempfile.mkdtemp(prefix="dslsh-elastic-")
        return self._workdir


def _migrated_cells(
    old_plan: routing.RoutingPlan,
    new_plan: routing.RoutingPlan,
    lost_nodes: list[int],
    dead_devices: list[int],
) -> int:
    """Cells whose placement changed between plans, plus restored cells
    and cells whose old placement sat on a permanently-dead device (a
    repair keeps the logical id but moves the replica to a fresh host).

    Placement comparison pads both ``cell_device`` maps to a common
    replica depth so adding/removing a replica counts as a move of that
    cell.
    """
    a, b = old_plan.cell_device, new_plan.cell_device
    r = max(a.shape[-1], b.shape[-1])

    def pad(x):
        out = np.full(x.shape[:-1] + (r,), -1, np.int32)
        out[..., : x.shape[-1]] = x
        return out

    moved = (pad(a) != pad(b)).any(axis=-1)
    for j in lost_nodes:
        moved[j, :] = True
    if dead_devices:
        dead = np.zeros(old_plan.n_devices, bool)
        dead[dead_devices] = True
        moved |= (dead[np.clip(a, 0, None)] & (a >= 0)).any(axis=-1)
    return int(moved.sum())
