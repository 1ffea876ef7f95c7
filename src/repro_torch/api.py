"""One typed DSLSH handle — the port's ``dslsh`` Deployment API.

Counterpart of ``repro.api``: the :func:`single`, :func:`grid`,
:func:`mesh` and :func:`streaming` deployments. A frozen
:class:`Deployment` says where the index runs, and one handle runs the
lifecycle::

    cfg = dslsh.make_config(dslsh.FamilyConfig(...), dslsh.BudgetConfig(...))
    index = dslsh.build(seed, data, cfg, dslsh.grid(nu=2, p=8))
    res = index.query(queries)          # one typed DistributedQueryResult

Everything runs on the CUDA card unless ``device="cpu"`` is passed. A
compressed payload (``payload="f16"``/``"i8"``) rides the single-shard
fused tail; a grid refuses it. A grid may be routed (DESIGN.md §10:
``grid(routed=True)``, ``replication``, ``degrade``), and the
:func:`streaming` deployment ingests, compacts and evicts online
(DESIGN.md §9). An ``obs`` bundle instruments the handle (DESIGN.md §12).
``index.save(path)`` / :func:`load` persist it in the JAX package's format
(``checkpoint/store.py``), so either package loads what the other saved,
and ``index.frontend(...)`` puts the multi-tenant serving front end
(``serve/frontend.py``, DESIGN.md §15) before it. A :func:`mesh`
deployment runs one rank per cell over ``torch.distributed``
(``launch.mesh``): every rank calls ``build``, ``query``, ``save`` and
``load`` alike, holds its own cell and gets the same merged answer.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import obs as obs_mod
from repro_torch import params as params_mod
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.core import distributed as D
from repro_torch.core import hashing, pipeline, routing, tables
from repro_torch.core.distributed import (  # noqa: F401  (re-exported public API)
    DistributedQueryResult,
    Grid,
    pad_to_multiple,
    pknn_query,
)
from repro_torch.core.pipeline import (  # noqa: F401  (re-exported public API)
    BudgetConfig,
    ConfigError,
    FamilyConfig,
    RuntimeConfig,
    SLSHConfig,
)
from repro_torch.runtime import memory as memory_mod
from repro_torch.runtime import payload as payload_mod
from repro_torch.sharding import ctx
from repro_torch.stream import delta as delta_mod
from repro_torch.stream import shard as shard_mod

__all__ = [
    "BudgetConfig",
    "ConfigError",
    "Deployment",
    "DistributedQueryResult",
    "FamilyConfig",
    "Grid",
    "Index",
    "MeshDeployment",
    "RuntimeConfig",
    "SLSHConfig",
    "build",
    "grid",
    "load",
    "make_config",
    "mesh",
    "pad_to_multiple",
    "pknn_query",
    "single",
    "streaming",
]

_KINDS = ("single", "grid", "mesh", "streaming")


def make_config(
    family: FamilyConfig | None = None,
    budget: BudgetConfig | None = None,
    runtime: RuntimeConfig | None = None,
    **overrides,
) -> SLSHConfig:
    """Compose a validated :class:`SLSHConfig` from its three parts; flat
    field names in ``overrides`` route to the matching sub-config."""
    return SLSHConfig.compose(family, budget, runtime, **overrides)


@dataclasses.dataclass(frozen=True)
class Deployment:
    """Frozen descriptor of where a DSLSH index runs; build one with
    :func:`single`, :func:`grid`, :func:`mesh` or :func:`streaming`."""

    kind: str
    nu: int = 1  # nodes (mesh axis "data")
    p: int = 1  # cores per node (mesh axis "model")
    replication: int = 1  # replica factor for hot cells (DESIGN.md §10)
    routed: bool = False  # key→cell routing (bit-exact)
    route_bits: int = routing.DEFAULT_BITS
    # deadline-degradation levels ((min_budget_s, max_cells), ...) read by
    # query(budget=...); they need ``routed``
    degrade: tuple | None = None
    # streaming knobs (DESIGN.md §9)
    node_capacity: int | None = None
    delta_cap: int = 64
    retention_s: float = float("inf")

    def __post_init__(self):
        pipeline._require(
            self.kind in _KINDS,
            f"unknown deployment kind {self.kind!r}; one of {_KINDS}",
        )
        pipeline._require(
            self.nu >= 1 and self.p >= 1,
            f"nu={self.nu}, p={self.p}: the cell grid needs at least one"
            " node and one core",
        )
        pipeline._require(
            self.replication >= 1,
            f"replication={self.replication}: replica counts start at 1",
        )
        pipeline._require(
            self.replication == 1 or self.routed or self.kind == "mesh",
            f"replication={self.replication} without routed=True: replica"
            " placement rides the §10 routing plan — pass routed=True (the"
            " routed query stays bit-identical to the broadcast one)",
        )
        pipeline._require(
            not self.degrade or self.routed,
            "degrade levels require routed=True (degradation caps the"
            " cells the §10 router probes)",
        )
        if self.kind == "streaming":
            pipeline._require(
                self.node_capacity is not None and self.node_capacity >= 1,
                "streaming deployments need node_capacity (the fixed"
                " per-node store size, >= warmup shard size)",
            )
            pipeline._require(
                self.delta_cap >= 1,
                f"delta_cap={self.delta_cap}: each node needs at least one"
                " delta slot to ingest into",
            )
        if self.kind == "mesh":
            pipeline._require(
                getattr(self, "mesh", None) is not None,
                "mesh deployments need the device mesh: pass"
                " dslsh.mesh(make_local_mesh(nu, p), ...)"
                " (repro_torch.launch.mesh)",
            )

    @property
    def grid(self) -> Grid:
        """The nu x p cell grid this deployment maps onto."""
        return Grid(nu=self.nu, p=self.p)

    @property
    def cells(self) -> int:
        """Total SLSH cells (the paper's nu*p)."""
        return self.nu * self.p


@dataclasses.dataclass(frozen=True)
class MeshDeployment(Deployment):
    """A :class:`Deployment` over a device mesh (:func:`mesh`): the grid's
    fields and the two that only a mesh has."""

    reducer: str = "allgather"  # the Reducer: "allgather" | "tree"
    # this rank's device mesh (never serialized)
    mesh: ctx.Mesh | None = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        super().__post_init__()
        pipeline._require(
            self.reducer in ("allgather", "tree"),
            f"unknown reducer {self.reducer!r}; one of ('allgather', 'tree')",
        )


def single() -> Deployment:
    """One shard on one device — the paper's single-node path."""
    return Deployment(kind="single")


def grid(
    nu: int = 1,
    p: int = 1,
    *,
    replication: int = 1,
    routed: bool | None = None,
    route_bits: int = routing.DEFAULT_BITS,
    degrade: tuple | None = None,
) -> Deployment:
    """The nu x p cell grid simulated on one device.

    ``routed=True`` builds a key→cell routing plan at build time and routes
    every query batch only to the cells its probe keys can land in
    (bit-identical results, fewer cells visited). ``replication > 1``
    replicates hot cells and ``degrade`` declares deadline-degradation
    levels for ``query(budget=...)``; both imply ``routed``.

    >>> grid(nu=2, p=4, replication=2).routed
    True
    """
    if routed is None:
        routed = replication > 1 or degrade is not None
    return Deployment(
        kind="grid", nu=nu, p=p, replication=replication, routed=routed,
        route_bits=route_bits, degrade=degrade,
    )


def streaming(
    nu: int = 1,
    p: int = 1,
    *,
    node_capacity: int,
    delta_cap: int = 64,
    retention_s: float = float("inf"),
    routed: bool = True,
    route_bits: int = routing.DEFAULT_BITS,
) -> Deployment:
    """The online deployment: ingest, auto-compact, evict (DESIGN.md §9).

    ``node_capacity`` fixes each node's store size (it must cover the
    node's warm-up shard); ``delta_cap`` sizes the append-only segments;
    windows older than ``retention_s`` are evicted during compaction.
    Routing is on by default and exact here too (delta segments inherit
    their cell's placement).

    >>> streaming(nu=2, node_capacity=256).kind
    'streaming'
    """
    return Deployment(
        kind="streaming", nu=nu, p=p, routed=routed, route_bits=route_bits,
        node_capacity=node_capacity, delta_cap=delta_cap, retention_s=retention_s,
    )


def mesh(
    device_mesh: ctx.Mesh,
    *,
    reducer: str = "allgather",
    routed: bool = False,
    route_bits: int = routing.DEFAULT_BITS,
    degrade: tuple | None = None,
) -> Deployment:
    """The cell grid over a device mesh, one rank per cell.

    ``device_mesh`` (``launch.mesh``) must carry ``data`` and ``model``
    axes; an optional leading ``rep`` axis replicates the index and
    row-splits query batches across the replicas (§10). The grid shape is
    read off the mesh. ``reducer`` merges the partial top-Ks by
    ``"allgather"`` or by the ``"tree"`` tournament (equal answers).
    """
    shape = device_mesh.shape
    return MeshDeployment(
        kind="mesh", nu=int(shape["data"]), p=int(shape["model"]),
        replication=int(shape.get("rep", 1)), routed=routed,
        route_bits=route_bits, reducer=reducer, degrade=degrade,
        mesh=device_mesh,
    )


class Index:
    """The typed DSLSH handle: deployment, config and built state.

    :meth:`query` always returns one :class:`DistributedQueryResult`,
    whatever the deployment; the handle adds no math of its own.
    :meth:`ingest`, :meth:`compact` and :meth:`snapshot` serve streaming
    deployments. ``obs`` binds an observability bundle: lifecycle calls
    then record spans and the query path feeds the metrics registry
    (latency, comparisons, overflow, routed_frac — DESIGN.md §12).
    """

    def __init__(self, deploy: Deployment, cfg: SLSHConfig, state: dict, obs: obs_mod.Obs | None = None):
        self.deploy = deploy
        self.cfg = cfg
        self._state = state
        self._obs = obs
        self._cached_payload: payload_mod.Payload | None = None

    # ------------------------------------------------------------- facts

    @property
    def grid(self) -> Grid:
        """The deployment's cell grid."""
        return self.deploy.grid

    @property
    def plan(self) -> routing.RoutingPlan | None:
        """The routing plan (None for unrouted deployments)."""
        return self._state.get("plan")

    @property
    def device(self) -> torch.device:
        """The device the index lives on."""
        if self.deploy.kind == "streaming":
            return self._state["core"].device
        return self._state["data"].device

    @property
    def pipeline_index(self):
        """The built pipeline state: one ``SLSHIndex`` (single; this rank's
        cell on a mesh), the cell indexes in flat (node, core) order
        (grid), or the per-node state list (streaming)."""
        if self.deploy.kind == "streaming":
            return self._state["core"].state
        return self._state["index"]

    def n_index(self) -> int:
        """Points queryable right now."""
        if self.deploy.kind == "streaming":
            return self._state["core"].n_index()
        if self.deploy.kind == "mesh":  # a rank holds its node's rows
            return self.deploy.nu * int(self._state["data"].shape[0])
        return int(self._state["data"].shape[0])

    def memory_report(self) -> memory_mod.MemoryReport:
        """Per-cell byte accounting of the resident index (DESIGN.md §13):
        tables, heavy, inner, data and payload bytes from tensor shapes
        alone, with no sync (on a mesh, what this rank holds). Batch
        deployments only."""
        pipeline._require(
            self.deploy.kind != "streaming",
            "memory_report covers batch deployments — streaming capacity"
            " is tracked live by ingest/compact reports (DESIGN.md §9)",
        )
        cells = (self.deploy.nu, self.deploy.p) if self.deploy.kind == "grid" else (1, 1)
        return memory_mod.index_report(
            self._state["index"], self._state["data"], self.cfg.payload, cells
        )

    def _payload(self) -> payload_mod.Payload | None:
        """The handle's quantized candidate payload, made once and cached
        (None for ``payload='f32'``: the exact rows serve directly)."""
        if self.cfg.payload == "f32":
            return None
        if self._cached_payload is None:
            self._cached_payload = payload_mod.make_payload(self._state["data"], self.cfg.payload)
        return self._cached_payload

    def _bound_obs(self) -> obs_mod.Obs | None:
        ob = self._obs if self._obs is not None else obs_mod.get_active()
        return ob if ob is not None and ob.enabled else None

    # ------------------------------------------------------------- query

    def query(
        self,
        queries,
        *,
        budget: float | None = None,
        max_cells: int | None = None,
        drop_mask=None,
        drop_cells=None,
    ) -> DistributedQueryResult:
        """Resolve a query batch -> one :class:`DistributedQueryResult`.

        ``budget`` (remaining latency seconds) maps through the
        deployment's ``degrade`` levels to a probe-cell cap; ``max_cells``
        caps it directly (both need a routed deployment and are
        approximate by design). ``drop_mask`` (nu,) excludes straggler
        nodes from the Reducer (grid and mesh deployments) and
        ``drop_cells`` (nu, p) lost cells (grid deployments). On a mesh
        every rank calls this with the same batch and gets the same result.
        With an obs bundle the call records an ``index.query`` span
        (synchronized) and feeds the query metrics.
        """
        if budget is not None:
            pipeline._require(
                self.deploy.degrade is not None,
                "query(budget=...) needs degrade levels on the deployment:"
                " dslsh.grid(..., routed=True, degrade=((0.05, None),"
                " (0.0, 4)))",
            )
            cap = routing.degrade_max_cells(budget, self.deploy.degrade)
            max_cells = cap if max_cells is None else min(max_cells, cap or max_cells)
        if max_cells is not None:
            pipeline._require(
                self.plan is not None,
                "max_cells requires a routed deployment (dslsh.grid(...,"
                " routed=True) or dslsh.mesh(..., routed=True)) — the cap"
                " rides the §10 routing plan",
            )
        if drop_cells is not None:
            pipeline._require(
                self.deploy.kind == "grid",
                "drop_cells (per-cell failover drops) applies to grid"
                " deployments — nodes on other deployments drop whole via"
                " drop_mask",
            )
        ob = self._bound_obs()
        if ob is None:
            return self._query_impl(queries, max_cells, drop_mask, drop_cells)
        q_n = int(np.shape(queries)[0])
        with ob.activate():
            with ob.span("index.query", deployment=self.deploy.kind, queries=q_n) as sp:
                res = self._query_impl(queries, max_cells, drop_mask, drop_cells)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        if ob.metrics is not None:
            self._record_query_metrics(ob, res, sp.dur_s)
        return res

    def _query_impl(self, queries, max_cells, drop_mask, drop_cells) -> DistributedQueryResult:
        """Deployment dispatch behind :meth:`query` (validation done)."""
        kind = self.deploy.kind
        if kind == "streaming":
            pipeline._require(
                drop_mask is None and drop_cells is None and max_cells is None,
                "streaming deployments answer with their live cells — drop_mask"
                " / max_cells degradation applies to grid/mesh deployments",
            )
            return self._state["core"].query(queries)
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        data, index = self._state["data"], self._state["index"]
        if kind == "single":
            pipeline._require(
                drop_mask is None,
                "drop_mask only applies to grid/mesh deployments (a single"
                " shard has no straggler nodes to drop)",
            )
            res = pipeline.query_batch(index, data, queries, self.cfg, self._payload())
            return DistributedQueryResult(
                res.knn_dist,
                res.knn_idx,
                res.comparisons[None, None],
                res.compaction_overflow[None, None],
                torch.ones((1, 1, queries.shape[0]), dtype=torch.bool, device=self.device),
                None if res.rerank_misses is None else res.rerank_misses[None, None],
            )
        if kind == "mesh":
            return D.mesh_query(
                self.deploy.mesh, index, data, queries, self.cfg, self.grid,
                reducer=self.deploy.reducer, drop_mask=drop_mask, plan=self.plan,
                max_cells=max_cells, family=self._state.get("family"),
            )
        return D.grid_query(
            index, data, queries, self.cfg, self.grid, plan=self.plan,
            max_cells=max_cells, drop_mask=drop_mask, drop_cells=drop_cells,
        )

    def _record_query_metrics(self, ob: obs_mod.Obs, res: DistributedQueryResult, dur_s: float) -> None:
        """Feed the query metrics (DESIGN.md §12) from one computed result."""
        m = ob.metrics
        kind = self.deploy.kind
        m.histogram(
            "dslsh_query_latency_seconds", "end-to-end Index.query wall time (synced)",
        ).labels(deployment=kind).observe(dur_s)
        m.counter("dslsh_queries_total", "Index.query batches answered").labels(deployment=kind).inc()
        comps = res.comparisons.cpu().numpy()  # (nu, p, Q)
        m.counter(
            "dslsh_comparisons_total",
            "unique candidates scanned across all cells (paper's cost"
            " measure)",
        ).inc(float(comps.sum()))
        comp_hist = m.histogram(
            "dslsh_query_comparisons",
            "per-query max unique candidates scanned in any one cell",
            buckets=obs_mod.metrics.COUNT_BUCKETS,
        )
        for v in comps.max(axis=(0, 1)):
            comp_hist.observe(float(v))
        m.counter(
            "dslsh_compaction_overflow_total",
            "unique survivors beyond c_comp — non-zero means results are"
            " budget-truncated (DESIGN.md §3)",
        ).inc(float(res.compaction_overflow.sum()))
        if res.rerank_misses is not None:
            m.counter(
                "dslsh_rerank_misses_total",
                "compressed-payload shortlist misses — non-zero means the"
                " quantized L1 pass may have excluded a true neighbour"
                " (raise c_rerank; DESIGN.md §13)",
            ).inc(float(res.rerank_misses.sum()))
        m.histogram(
            "dslsh_routed_frac",
            "fraction of (cell, query) pairs the §10 router visited",
            buckets=obs_mod.log_buckets(0.01, 1.0, per_decade=8),
        ).observe(float(res.routed_frac))
        routed = res.routed.cpu().numpy()  # (nu, p, Q)
        per_cell = routed.sum(axis=2)
        cell_counter = m.counter(
            "dslsh_routed_queries_per_cell_total",
            "queries routed to each (node, core) cell — the load signal"
            " the routing plan's replicas balance",
        )
        for j in range(per_cell.shape[0]):
            for c in range(per_cell.shape[1]):
                cell_counter.labels(cell=f"{j}/{c}").inc(float(per_cell[j, c]))
        plan = self.plan
        if plan is not None and plan.r_max > 1:
            load = routing.device_load(plan, routed.transpose(2, 0, 1))
            dev_counter = m.counter(
                "dslsh_replica_routed_queries_total",
                "queries each replica device answered (replication load"
                " balance, §10)",
            )
            for d, v in enumerate(load):
                dev_counter.labels(device=str(d)).inc(float(v))

    def with_obs(self, obs: obs_mod.Obs | None) -> "Index":
        """The same handle state bound to a (different) obs bundle."""
        out = Index(self.deploy, self.cfg, self._state, obs)
        out._cached_payload = self._cached_payload
        return out

    def with_routing(
        self,
        *,
        replication: int = 1,
        route_bits: int = routing.DEFAULT_BITS,
        degrade: tuple | None = None,
    ) -> "Index":
        """A routed variant of this grid handle, sharing the built state: the
        key→cell map and replica placement come from the built cells (no
        re-hash of the data); queries route, bit-identical to broadcast."""
        pipeline._require(
            self.deploy.kind == "grid",
            "with_routing derives a plan from a grid deployment — mesh"
            " and streaming deployments take routed=True at build time",
        )
        plan = routing.make_plan(
            self._state["index"], self.cfg, self.grid, replication=replication, bits=route_bits
        )
        deploy = dataclasses.replace(
            self.deploy, routed=True, replication=replication, route_bits=route_bits, degrade=degrade,
        )
        return Index(deploy, self.cfg, {**self._state, "plan": plan}, self._obs)

    def query_with_stats(self, queries) -> tuple[DistributedQueryResult, routing.RoutingStats]:
        """Routed-grid query + host-side :class:`routing.RoutingStats`
        (route mask, Reducer payload accounting, per-device load)."""
        pipeline._require(
            self.deploy.kind == "grid" and self.plan is not None,
            "query_with_stats needs a routed grid deployment (dslsh.grid(..., routed=True))",
        )
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return D.grid_query(
            self._state["index"], self._state["data"], queries, self.cfg, self.grid,
            plan=self.plan, return_stats=True,
        )

    # --------------------------------------------------------- streaming

    def _core(self) -> shard_mod.ShardedStream:
        pipeline._require(
            self.deploy.kind == "streaming",
            f"{self.deploy.kind!r} deployments are immutable — ingest /"
            " compact need dslsh.streaming(...) (build a fresh index to"
            " change batch deployments)",
        )
        return self._state["core"]

    def ingest(self, xs, ts: float = 0.0) -> shard_mod.IngestReport:
        """Ingest one batch of points stamped ``ts`` (streaming only): the
        Forwarder routes it to the next node round-robin; a node whose delta
        would overflow compacts (and, past the retention horizon, evicts)
        first."""
        core = self._core()
        ob = self._bound_obs()
        if ob is None:
            return core.ingest(xs, float(ts))
        with ob.activate(), ob.span("index.ingest", ts=float(ts)):
            return core.ingest(xs, float(ts))

    def compact(self, ts: float = 0.0) -> list:
        """Fold every node's delta segment into its base now (streaming
        only); one ``(evicted, keep)`` pair per node, ``keep`` the
        renumbering map when eviction moved rows."""
        core = self._core()
        ob = self._bound_obs()
        if ob is None:
            return core.compact_all(float(ts))
        with ob.activate(), ob.span("index.compact", ts=float(ts)):
            return core.compact_all(float(ts))

    def snapshot(self) -> "Index":
        """An RCU snapshot for ingest-while-serving (DESIGN.md §15). Batch
        deployments are immutable, so the snapshot is the handle itself; a
        streaming handle gets a clone of its core, sharing every tensor,
        which keeps answering from the state it took."""
        if self.deploy.kind != "streaming":
            return self
        return Index(self.deploy, self.cfg, {**self._state, "core": self._state["core"].clone()}, self._obs)

    # ----------------------------------------------------------- serving

    def frontend(self, cfg=None, **kw):
        """An async multi-tenant serving front end over this handle
        (DESIGN.md §15): admission control, micro-batch coalescing onto the
        ladder of batch shapes, deadline-aware degradation and (streaming)
        RCU ingest-while-serving. ``cfg`` is a
        :class:`repro_torch.serve.frontend.FrontendConfig`; keywords pass
        through to :class:`repro_torch.serve.frontend.ServeFrontend`."""
        from repro_torch.serve import frontend as frontend_mod

        kw.setdefault("obs", self._obs)
        return frontend_mod.ServeFrontend(self, cfg, **kw)

    # ------------------------------------------------------- persistence

    def save(self, path: str) -> str:
        """Persist this index to ``path`` (a directory), in the JAX
        package's format: the tensors through ``checkpoint/store.py``
        (atomic rename, one .npy per leaf, grid cells stacked ``(nu, p)``,
        keys and salts ``uint32``), the deployment, config and host-side
        cursors in ``dslsh.json``. :func:`load` restores the handle, and so
        does ``repro.api.load``; round trips are bit-exact. On a mesh every
        rank calls it: rank 0 gathers the cells and the nodes' rows and
        writes the JAX package's mesh checkpoint, and every rank returns
        once it is written."""
        ob = self._bound_obs()
        span = ob.span("index.save", path=path) if ob is not None else obs_mod.NULL_SPAN
        with span:
            state, extra = _state_arrays(self)
            if state is not None:
                os.makedirs(path, exist_ok=True)
                ckpt_store.save({"state": state}, 0, path)
                meta = {
                    "format": 1,
                    "cfg": _cfg_dict(self.cfg),
                    "deploy": _deploy_dict(self.deploy),
                    "extra": extra,
                }
                with open(os.path.join(path, "dslsh.json"), "w") as f:
                    json.dump(meta, f, indent=2)
            if self.deploy.kind == "mesh":
                ctx.barrier(self.deploy.mesh)
            return path


def _family(seed: int, d: int, cfg: SLSHConfig, dev: torch.device, params):
    if params is None:
        return pipeline.family_from_key(seed, d, cfg, dev)
    outer, inner = params
    if isinstance(outer, hashing.BitSampleParams) and isinstance(inner, hashing.SignRPParams):
        return pipeline.family_from_key((outer, inner), d, cfg, dev)
    return params_mod.from_jax_params(outer, inner, dev)


def build(
    seed: int,
    data,
    cfg: SLSHConfig,
    deploy: Deployment,
    device: str | torch.device | None = None,
    *,
    params=None,
    t0: float = 0.0,
    obs: obs_mod.Obs | None = None,
) -> Index:
    """Build a DSLSH index over ``data`` (n, d) for ``deploy`` -> :class:`Index`.

    ``seed`` draws the one root hash family every cell slices its tables
    from; ``params`` instead supplies it as an ``(outer, inner)`` pair —
    the port's parameter types, or numpy arrays such as the JAX package's
    family (see ``repro_torch.params``). For grid and streaming deployments
    ``n`` must divide across the nodes (:func:`pad_to_multiple`). ``t0``
    stamps a streaming deployment's warm-up windows. ``obs`` binds an
    observability bundle: the build records an ``index.build`` span and
    the handle is instrumented. Runs on the CUDA card unless ``device``
    says otherwise; a mesh deployment runs on its mesh's device. On a mesh
    every rank calls ``build`` with the same arguments (``data`` may be a
    memory-mapped array: a rank reads only its node's rows), so every rank
    hashes with the same family, and keeps its own cell.
    """
    if deploy.kind == "mesh":
        dev = deploy.mesh.device
        pipeline._require(
            device is None or torch.device(device) == dev,
            f"device={device!r}: a mesh deployment builds on its mesh's"
            f" device ({dev}) — pass the device to make_local_mesh",
        )
    else:
        dev = device_mod.resolve(device)
    if obs is not None and obs.enabled:
        n = int(np.shape(data)[0])
        with obs.activate(), obs.span("index.build", deployment=deploy.kind, n=n):
            out = _build_impl(seed, data, cfg, deploy, dev, params, t0, obs)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if obs.metrics is not None and deploy.kind != "streaming":
            out.memory_report().feed_gauges(obs.metrics)
        return out
    return _build_impl(seed, data, cfg, deploy, dev, params, t0, obs)


def _build_impl(seed, data, cfg, deploy, dev, params, t0, obs) -> Index:
    n, d = (int(s) for s in np.shape(data))
    family = _family(seed, d, cfg, dev, params)
    if deploy.kind == "single":
        data = torch.as_tensor(data, dtype=torch.float32, device=dev).contiguous()
        index = pipeline.build_from_params(data, *family, cfg)
        return Index(deploy, cfg, {"index": index, "data": data}, obs)
    pipeline._require(
        cfg.payload == "f32",
        f"payload={cfg.payload!r} (compressed candidate payload) rides"
        " the single-shard fused tail — grid/mesh/streaming"
        " deployments need payload='f32' (DESIGN.md §13)",
    )
    pipeline._require(
        cfg.L_out % deploy.p == 0,
        f"L_out={cfg.L_out} does not divide across p={deploy.p} cores"
        " (paper: each core owns L_out/p tables) — adjust L_out or p",
    )
    pipeline._require(
        n % deploy.nu == 0,
        f"n={n} does not divide across nu={deploy.nu} nodes — pad the"
        " dataset first (dslsh.pad_to_multiple(points, labels,"
        f" {deploy.cells}))",
    )
    if deploy.kind == "mesh":
        mesh, g = deploy.mesh, deploy.grid
        local = D.node_rows(mesh, data, g)
        state = {"index": D.dslsh_build(mesh, family, local, cfg, g), "data": local}
        if deploy.routed:
            state["family"] = family[0]
            state["plan"] = routing.make_mesh_plan(
                mesh, state["index"], cfg, g, replication=1, bits=deploy.route_bits
            )
        return Index(deploy, cfg, state, obs)
    data = torch.as_tensor(data, dtype=torch.float32, device=dev).contiguous()
    if deploy.kind == "streaming":
        core = shard_mod.ShardedStream(
            family, data, cfg, deploy.grid,
            node_capacity=deploy.node_capacity, delta_cap=deploy.delta_cap,
            retention_s=deploy.retention_s, t0=t0, route=deploy.routed,
            route_bits=deploy.route_bits, device=dev,
        )
        return Index(deploy, cfg, {"core": core}, obs)
    index = D.simulate_build(family, data, cfg, deploy.grid)
    state = {"index": index, "data": data}
    if deploy.routed:
        state["plan"] = routing.make_plan(
            index, cfg, deploy.grid, replication=deploy.replication, bits=deploy.route_bits
        )
    return Index(deploy, cfg, state, obs)


def wrap_grid(index, data, cfg: SLSHConfig, grid_: Grid, plan=None, obs: obs_mod.Obs | None = None) -> Index:
    """Wrap a prebuilt ``core.distributed.simulate_build`` index (its cell
    list) over ``data`` into a grid-deployment handle, routed when ``plan``
    (a ``routing.RoutingPlan`` of that index) is given: the bridge legacy
    call sites migrate through. ``data`` goes to the index's device as
    float32."""
    deploy = Deployment(kind="grid", nu=grid_.nu, p=grid_.p, routed=plan is not None)
    dev = index[0].inner_keys.device
    data = data if isinstance(data, torch.Tensor) else np.asarray(data)
    state = {"index": index, "data": torch.as_tensor(data, dtype=torch.float32, device=dev).contiguous()}
    if plan is not None:
        state["plan"] = plan
    return Index(deploy, cfg, state, obs)


def wrap_single(index: pipeline.SLSHIndex, data, cfg: SLSHConfig, obs: obs_mod.Obs | None = None) -> Index:
    """Wrap a prebuilt ``pipeline.build_from_params`` (or
    ``slsh.build_index``) index over ``data`` into a single-shard handle:
    the bridge for legacy call sites. ``data`` goes to the index's device
    as float32."""
    data = data if isinstance(data, torch.Tensor) else np.asarray(data)
    dev = index.inner_keys.device
    return Index(single(), cfg, {"index": index, "data": torch.as_tensor(data, dtype=torch.float32,
                                                                          device=dev).contiguous()}, obs)


def load(
    path: str, *, device_mesh: ctx.Mesh | None = None,
    device: str | torch.device | None = None, obs: obs_mod.Obs | None = None,
) -> Index:
    """Restore an :class:`Index` saved by :meth:`Index.save` or by the JAX
    package's ``Index.save``, on ``device`` (the card unless told
    otherwise). An index saved from a mesh needs a mesh of the same shape
    handed back in ``device_mesh``; every rank then calls ``load`` and
    reads only its own cell and its node's rows, on the mesh's device.
    ``obs`` instruments the restored handle and records an ``index.load``
    span around the restore."""
    with open(os.path.join(path, "dslsh.json")) as f:
        meta = json.load(f)
    dep = dict(meta["deploy"])
    if dep["kind"] == "mesh":
        pipeline._require(
            device_mesh is not None,
            "this index was saved from a mesh deployment; device meshes"
            " are not serializable — pass load(path,"
            " device_mesh=make_local_mesh(nu, p)) (repro_torch.launch.mesh)",
        )
        shape = device_mesh.shape
        pipeline._require(
            (shape.get("rep", 1), shape.get("data"), shape.get("model"))
            == (dep["replication"], dep["nu"], dep["p"]),
            f"the index was saved from a rep x data x model ="
            f" {dep['replication']}x{dep['nu']}x{dep['p']} mesh; device_mesh"
            f" has {shape}",
        )
        pipeline._require(
            device is None or torch.device(device) == device_mesh.device,
            f"device={device!r}: a mesh index loads on its mesh's device"
            f" ({device_mesh.device})",
        )
        dep["mesh"] = device_mesh
    else:
        dep.pop("reducer", None)  # a mesh's knob
    if dep.get("retention_s") is None:
        dep["retention_s"] = float("inf")
    if dep.get("degrade") is not None:
        dep["degrade"] = tuple(tuple(level) for level in dep["degrade"])
    deploy = (MeshDeployment if dep["kind"] == "mesh" else Deployment)(**dep)
    cfg_kw = dict(meta["cfg"])
    cfg_kw["backend"] = _PORT_BACKEND.get(cfg_kw["backend"], cfg_kw["backend"])
    cfg_kw["interpret"] = None  # a JAX execution knob the port has no use for
    cfg = SLSHConfig.compose(**cfg_kw)
    dev = device_mesh.device if deploy.kind == "mesh" else device_mod.resolve(device)
    ob = obs if obs is not None and obs.enabled else None
    if ob is None:
        return _rehydrate(deploy, cfg, _restore(deploy, path), meta["extra"], dev, obs)
    with ob.activate(), ob.span("index.load", path=path):
        return _rehydrate(deploy, cfg, _restore(deploy, path), meta["extra"], dev, obs)


def _restore(deploy: Deployment, path: str) -> dict:
    """The saved state tree: numpy leaves, or on a mesh this rank's blocks
    (cells split ``(data, model)``, rows ``data``) as tensors on its
    device."""
    skel = _state_skeleton(deploy)
    if deploy.kind != "mesh":
        return ckpt_store.restore({"state": skel}, 0, path)["state"]
    mesh = deploy.mesh
    cell = ctx.NamedSharding(mesh, ("data", "model"))
    shardings = {"index": _tree_map(lambda _: cell, skel["index"]), "data": ctx.NamedSharding(mesh, ("data",))}
    if "plan" in skel:
        shardings["plan"] = {k: ctx.NamedSharding(mesh) for k in skel["plan"]}
    return ckpt_store.restore({"state": skel}, 0, path, shardings={"state": shardings})["state"]


# ----------------------------------------------------- persistence helpers

# the JAX package's backend names in dslsh.json: its plain path and its
# hand-written kernels, as the port's "torch" and "cuda"
_JAX_BACKEND = {"torch": "reference", "cuda": "pallas"}
_PORT_BACKEND = {v: k for k, v in _JAX_BACKEND.items()}


def _cfg_dict(cfg: SLSHConfig) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(SLSHConfig)}
    out["backend"] = _JAX_BACKEND[cfg.backend]
    return out


def _deploy_dict(deploy: Deployment) -> dict:
    out = {f.name: getattr(deploy, f.name) for f in dataclasses.fields(deploy) if f.name != "mesh"}
    out.setdefault("reducer", "allgather")  # the JAX package's mesh Reducer field, at its default
    if not np.isfinite(out["retention_s"]):
        out["retention_s"] = None  # JSON has no inf
    return out


def _tree_map(fn, tree):
    """``fn`` over the leaves of a NamedTuple tree."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return fn(tree)


def _stack(trees: list, shape: tuple[int, ...]):
    """Equal-shaped NamedTuple trees of numpy leaves stacked leaf by leaf
    into leading dims ``shape`` (the JAX package's vmapped layout)."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack([t[i] for t in trees], shape) for i in range(len(first))))
    return np.stack([np.asarray(t) for t in trees]).reshape(shape + np.shape(first))


def _state_arrays(index: Index) -> tuple[dict | None, dict]:
    """(the tree to checkpoint, host-side extras for the JSON sidecar), in
    the JAX package's layout; on a mesh a collective, whose tree is None
    on every rank but 0."""
    st = index._state
    if index.deploy.kind == "mesh":
        return _gather_mesh_state(index), {}
    if index.deploy.kind == "streaming":
        core: shard_mod.ShardedStream = st["core"]
        p = index.deploy.p
        nodes = []
        for nd in core.state:
            cells = shard_mod.CellState(
                _stack([params_mod.index_to_numpy(c.base) for c in nd.cells], (p,)),
                delta_mod.DeltaIndex(
                    np.stack([params_mod.u32(c.delta.outer_keys) for c in nd.cells]),
                    np.stack([params_mod.u32(c.delta.inner_keys) for c in nd.cells]),
                    np.asarray([c.delta.count for c in nd.cells], np.int32),
                    np.asarray([c.delta.dropped for c in nd.cells], np.int32),
                ),
                np.stack([c.occ.cpu().numpy() for c in nd.cells]),
            )
            nodes.append(shard_mod.NodeState(nd.store.cpu().numpy(), nd.ts.cpu().numpy(), cells))
        outer, inner = params_mod.family_to_numpy(*core.family)
        return {"nodes": nodes, "family": {"outer": outer, "inner": inner}}, {"rr": core.rr}
    data = st["data"].cpu().numpy()
    if index.deploy.kind == "single":
        return {"index": params_mod.index_to_numpy(st["index"]), "data": data}, {}
    return _grid_tree(index.deploy, st["index"], data, st.get("plan")), {}


def _grid_tree(deploy: Deployment, cells: list, data: np.ndarray, plan) -> dict:
    """A grid's (or mesh's) checkpoint tree: cells stacked ``(nu, p)``."""
    tree = {"index": _stack([params_mod.index_to_numpy(c) for c in cells], (deploy.nu, deploy.p)), "data": data}
    if plan is not None:
        tree["plan"] = {
            "occupancy": plan.occupancy.cpu().numpy(),
            "replicas": np.asarray(plan.replicas, np.int32),
            "heat": np.asarray(plan.heat, np.float32),
            "cell_device": np.asarray(plan.cell_device, np.int32),
        }
    return tree


def _gather_mesh_state(index: Index) -> dict | None:
    """(collective) Rank 0 gathers every cell of replica 0 and every
    node's rows (from its core 0) and returns the grid's checkpoint tree;
    every other rank returns None."""
    dep, st = index.deploy, index._state
    mesh = dep.mesh
    lead = (0,) if "rep" in mesh.shape else ()
    cells = [mesh.rank_of(lead + (j, c)) for j in range(dep.nu) for c in range(dep.p)]
    cell = st["index"]
    cell = cell._replace(n=torch.tensor(cell.n, device=st["data"].device))
    got = _tree_map(lambda t: ctx.gather_to(mesh, t, cells), cell)
    rows = ctx.gather_to(mesh, st["data"], [mesh.rank_of(lead + (j, 0)) for j in range(dep.nu)])
    if rows is None:
        return None
    parts = [_tree_map(lambda lst, i=i: lst[i], got) for i in range(len(cells))]
    parts = [c._replace(n=int(c.n)) for c in parts]
    return _grid_tree(dep, parts, torch.cat(rows).numpy(), st.get("plan"))


def _skel_index() -> pipeline.SLSHIndex:
    """A structure-only SLSHIndex (placeholder leaves) for restore."""
    return pipeline.SLSHIndex(
        hashing.BitSampleParams(0, 0, 0),
        hashing.SignRPParams(0, 0),
        tables.TableSet(0, 0),
        tables.HeavyBuckets(0, 0, 0, 0, 0),
        0, 0, 0,
    )


def _state_skeleton(deploy: Deployment) -> dict:
    if deploy.kind == "streaming":
        cell = shard_mod.CellState(_skel_index(), delta_mod.DeltaIndex(0, 0, 0, 0), 0)
        return {
            "nodes": [shard_mod.NodeState(0, 0, cell) for _ in range(deploy.nu)],
            "family": {"outer": hashing.BitSampleParams(0, 0, 0), "inner": hashing.SignRPParams(0, 0)},
        }
    tree = {"index": _skel_index(), "data": 0}
    if deploy.routed:
        tree["plan"] = {"occupancy": 0, "replicas": 0, "heat": 0, "cell_device": 0}
    return tree


def _rehydrate(deploy: Deployment, cfg: SLSHConfig, state: dict, extra: dict, dev: torch.device,
               obs: obs_mod.Obs | None) -> Index:
    """The handle over restored numpy ``state``, moved to ``dev``."""
    def on(a, dtype=None):
        t = torch.as_tensor(np.asarray(a, np.int64) if dtype == torch.int64 else np.asarray(a), device=dev)
        return t if dtype is None else t.to(dtype)

    if deploy.kind == "streaming":
        nodes = []
        for nd in state["nodes"]:
            c = nd.cells
            cells = [
                shard_mod.CellState(
                    params_mod.index_from_numpy(_tree_map(lambda a, i=i: a[i], c.base), dev),
                    delta_mod.DeltaIndex(
                        on(c.delta.outer_keys[i], torch.int64), on(c.delta.inner_keys[i], torch.int64),
                        int(c.delta.count[i]), int(c.delta.dropped[i]),
                    ),
                    on(c.occ[i]),
                )
                for i in range(deploy.p)
            ]
            nodes.append(shard_mod.NodeState(on(nd.store), on(nd.ts), cells))
        family = params_mod.from_jax_params(state["family"]["outer"], state["family"]["inner"], dev)
        core = shard_mod.ShardedStream.from_state(
            nodes, family, cfg, deploy.grid,
            node_capacity=deploy.node_capacity, delta_cap=deploy.delta_cap,
            retention_s=deploy.retention_s, route=deploy.routed,
            route_bits=deploy.route_bits, rr=int(extra.get("rr", 0)), device=dev,
        )
        return Index(deploy, cfg, {"core": core}, obs)
    if deploy.kind == "mesh":  # this rank's blocks, already on its device
        mesh = deploy.mesh
        cell = params_mod.index_from_numpy(_tree_map(lambda t: t[0, 0], state["index"]), dev)
        new_state = {"index": cell, "data": state["data"].to(torch.float32)}
        if deploy.routed and "plan" in state:
            p = state["plan"]
            new_state["family"] = D.mesh_family(mesh, cell)
            new_state["plan"] = routing.RoutingPlan(
                occupancy=p["occupancy"].to(torch.bool),
                replicas=p["replicas"].cpu().numpy().astype(np.int32),
                heat=p["heat"].cpu().numpy().astype(np.float32),
                cell_device=p["cell_device"].cpu().numpy().astype(np.int32),
            )
        return Index(deploy, cfg, new_state, obs)
    data = on(state["data"])
    ix = state["index"]
    if deploy.kind == "single":
        return Index(deploy, cfg, {"index": params_mod.index_from_numpy(ix, dev), "data": data}, obs)
    cells = [
        params_mod.index_from_numpy(_tree_map(lambda a, j=j, c=c: a[j, c], ix), dev)
        for j in range(deploy.nu)
        for c in range(deploy.p)
    ]
    new_state = {"index": cells, "data": data}
    if deploy.routed and "plan" in state:
        p = state["plan"]
        new_state["plan"] = routing.RoutingPlan(
            occupancy=on(p["occupancy"]),
            replicas=np.asarray(p["replicas"], np.int32),
            heat=np.asarray(p["heat"], np.float32),
            cell_device=np.asarray(p["cell_device"], np.int32),
        )
    return Index(deploy, cfg, new_state, obs)
