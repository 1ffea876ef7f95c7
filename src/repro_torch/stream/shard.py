"""Sharded streaming DSLSH core: the label-free state machine under both
the ``dslsh`` streaming deployment and the ICU ``StreamingMonitor``.

Counterpart of ``repro.stream.shard``. One :class:`ShardedStream` owns a
``Grid`` of streaming cells (DESIGN.md §9/§11): the Forwarder routes each
arriving window batch to one node (round-robin), every core of that node
appends it to its delta segment, and queries fan out over base + delta on
every cell with a unique-by-index top-K merge into one
``DistributedQueryResult``.

One :class:`NodeState` per node holds a single point store shared by the
node's ``p`` cells, and the cells as a Python list (the JAX package stacks
them with ``vmap``). A node whose delta would overflow compacts first;
under a retention horizon compaction also evicts windows older than
``t - retention_s``, and :class:`IngestReport` carries the surviving-row
map so callers can renumber per-point metadata.

Every update builds new tensors, so an RCU clone (:meth:`ShardedStream.
clone`) that shares the old ones keeps answering from its own state. The
host ints ``base.n`` and ``delta.count`` drive every overflow decision,
so an ingest reads nothing back from the device (the obs span aside,
which synchronizes).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import obs as obs_mod
from repro_torch.core import distributed as D
from repro_torch.core import hashing, pipeline, routing, topk
from repro_torch.stream import delta as delta_mod
from repro_torch.stream import index as stream_index


class CellState(NamedTuple):
    """One core's share of a node: its tables and delta keys (no store).

    ``occ`` is the cell's coarse key→cell map over its *base* tables; the
    delta segment inherits the cell's placement, so a query ORs the live
    delta keys' occupancy in and the map stays exact between compactions.
    """

    base: pipeline.SLSHIndex  # capacity-padded CSR tables (DESIGN.md §9.1)
    delta: delta_mod.DeltaIndex
    occ: torch.Tensor  # (L_loc, 2**route_bits) bool key→cell map


class NodeState(NamedTuple):
    """One streaming node: a shared point store and its ``p`` cells."""

    store: torch.Tensor  # (capacity, d), shared by the node's p cells
    ts: torch.Tensor  # (capacity,)
    cells: list[CellState]

    @property
    def n(self) -> int:
        """Rows in the node's base tables (equal across its cells)."""
        return self.cells[0].base.n

    @property
    def count(self) -> int:
        """Occupied delta slots (equal across its cells)."""
        return self.cells[0].delta.count


def _cell_params(family, cfg, grid, core_id: int):
    outer, inner = family
    l_loc = cfg.L_out // grid.p
    rows = slice(core_id * l_loc, (core_id + 1) * l_loc)
    return hashing.BitSampleParams(outer.dims[rows], outer.thrs[rows], outer.salts[rows]), inner


def _fresh_cell(base: pipeline.SLSHIndex, capacity: int, delta_cap: int, cfg, route_bits: int) -> CellState:
    base = base._replace(outer=stream_index.pad_tables(base.outer, capacity))
    occ = routing.cell_occupancy(base.outer.sorted_keys, base.n, route_bits)
    l_loc = base.outer_params.salts.shape[0]
    return CellState(base, delta_mod.make_delta(delta_cap, l_loc, cfg.L_in, occ.device), occ)


def node_init(
    family,
    data_local: torch.Tensor,
    cfg: pipeline.SLSHConfig,
    grid: D.Grid,
    *,
    capacity: int,
    delta_cap: int,
    t0: float = 0.0,
    route_bits: int = routing.DEFAULT_BITS,
) -> NodeState:
    """One node: p cells over a shared store of the node's data slice."""
    n0 = data_local.shape[0]
    if capacity < n0:
        raise ValueError(f"node capacity {capacity} below its warm-up shard of {n0}")
    cells = [
        _fresh_cell(
            pipeline.build_from_params(data_local, *_cell_params(family, cfg, grid, c), cfg),
            capacity, delta_cap, cfg, route_bits,
        )
        for c in range(grid.p)
    ]
    store, ts = stream_index._store(data_local, capacity, torch.tensor(t0, dtype=torch.float32))
    return NodeState(store, ts, cells)


def cell_as_stream(cell: CellState, node: NodeState) -> stream_index.StreamIndex:
    """View one cell as a single-shard StreamIndex (for host maintenance)."""
    return stream_index.StreamIndex(cell.base, cell.delta, node.store, node.ts)


@dataclasses.dataclass
class IngestReport:
    """What one :meth:`ShardedStream.ingest` call did (host-side facts).

    ``slots`` are the node-local store rows the batch landed in (after any
    maintenance) and ``keep`` — set only when maintenance evicted — maps
    old store rows to survivors (old row ``keep[i]`` became row ``i``).
    """

    node: int  # node the batch was routed to
    inserted: int  # windows absorbed into the node's delta segment
    dropped: int  # windows dropped (delta + store both full)
    compacted: bool  # node compacted before this ingest
    evicted: int  # stale windows evicted during that compaction
    slots: np.ndarray  # (inserted,) node-local store rows written
    keep: np.ndarray | None  # surviving old rows (ascending) when evicted


def _on(x, dev: torch.device) -> torch.Tensor:
    """A float32 tensor on ``dev`` from a tensor or array-like."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ShardedStream:
    """Label-free sharded streaming DSLSH core (DESIGN.md §9/§11).

    Holds the per-node state list and the round-robin Forwarder cursor.
    ``key`` names the root hash family (a seed, a ``torch.Generator`` or an
    ``(outer, inner)`` pair, ``pipeline.family_from_key``); the state lives
    on ``device`` (the card unless told otherwise).

    >>> import numpy as np
    >>> from repro_torch.core import distributed as D
    >>> cfg = pipeline.SLSHConfig.compose(m_out=8, L_out=4, m_in=4, L_in=2,
    ...     alpha=0.05, k=3, val_lo=0.0, val_hi=1.0, c_max=16, c_in=8,
    ...     h_max=2, p_max=32, query_chunk=8, use_inner=False, backend="torch")
    >>> pts = np.random.default_rng(0).uniform(0, 1, (32, 8)).astype(np.float32)
    >>> core = ShardedStream(0, pts, cfg, D.Grid(nu=1, p=1),
    ...                      node_capacity=64, delta_cap=16, device="cpu")
    >>> rep = core.ingest(pts[:4], t=1.0)
    >>> (rep.inserted, rep.dropped, core.n_index())
    (4, 0, 36)
    >>> core.query(pts[:2]).knn_idx[:, 0].tolist()  # points find themselves
    [0, 1]
    """

    def __init__(
        self,
        key,
        init_points,
        cfg: pipeline.SLSHConfig,
        grid: D.Grid,
        *,
        node_capacity: int,
        delta_cap: int,
        retention_s: float = float("inf"),
        t0: float = 0.0,
        route: bool = True,
        route_bits: int = routing.DEFAULT_BITS,
        device: str | torch.device | None = None,
    ):
        dev = device_mod.resolve(device)
        pts = _on(init_points, dev)
        n0 = pts.shape[0]
        if n0 == 0 or n0 % grid.nu:
            raise ValueError(f"the warm-up set of {n0} points must divide across nu={grid.nu} nodes")
        self.cfg, self.grid, self.device = cfg, grid, dev
        self.node_capacity, self.delta_cap = node_capacity, delta_cap
        self.retention_s = retention_s
        self.route, self.route_bits = route, route_bits
        # the full root family the cells slice their tables from: the
        # router and the ingest hash each batch against it once
        self.family = pipeline.family_from_key(key, pts.shape[1], cfg, dev)
        self.rr = 0  # round-robin Forwarder cursor
        n_loc = n0 // grid.nu
        self.state = [
            node_init(
                self.family, pts[i * n_loc : (i + 1) * n_loc], cfg, grid,
                capacity=node_capacity, delta_cap=delta_cap, t0=t0, route_bits=route_bits,
            )
            for i in range(grid.nu)
        ]
        self._make_programs()

    @classmethod
    def from_state(
        cls,
        state: list[NodeState],
        family,
        cfg: pipeline.SLSHConfig,
        grid: D.Grid,
        *,
        node_capacity: int,
        delta_cap: int,
        retention_s: float = float("inf"),
        route: bool = True,
        route_bits: int = routing.DEFAULT_BITS,
        rr: int = 0,
        device: str | torch.device | None = None,
    ) -> "ShardedStream":
        """Rehydrate a driver from restored state (``dslsh.load``): the node
        list, the root ``(outer, inner)`` family and the Forwarder cursor
        ``rr``, all on ``device`` (the card unless told otherwise)."""
        self = cls.__new__(cls)
        self.cfg, self.grid, self.device = cfg, grid, device_mod.resolve(device)
        self.node_capacity, self.delta_cap = node_capacity, delta_cap
        self.retention_s = retention_s
        self.route, self.route_bits = route, route_bits
        self.family = family
        self.rr = rr
        self.state = list(state)
        self._make_programs()
        return self

    def _make_programs(self) -> None:
        # the counterpart of the JAX package's two jit programs: one
        # count each, shared by every clone (zero recounts per snapshot)
        obs_mod.count_retrace("stream_insert")
        obs_mod.count_retrace("stream_query")

    def clone(self, *, cfg: pipeline.SLSHConfig | None = None, route: bool | None = None) -> "ShardedStream":
        """Cheap RCU copy for ingest-while-serving (DESIGN.md §15): a new
        node list sharing every tensor. Updates replace list slots and
        tensors, never write into shared ones, so the copy keeps its state.
        ``cfg`` / ``route`` give the copy another config (say the other
        backend) or routing switch over the same state."""
        out = self.__class__.__new__(self.__class__)
        out.__dict__.update(self.__dict__)
        out.state = list(self.state)
        if cfg is not None:
            out.cfg = cfg
        if route is not None:
            out.route = route
        return out

    # ---------------------------------------------------------------- insert

    def _insert(self, node: NodeState, xs: torch.Tensor, t: float) -> NodeState:
        """Ingest one batch into one node: the batch is hashed once against
        the full family (each table's keys equal its cell's own hash) and
        each cell takes its tables' columns; the store is written once."""
        n = node.n
        room = stream_index.delta_room(self.node_capacity, self.delta_cap, n)
        outer_keys, inner_keys = stream_index.hash_for_insert(
            node.cells[0].base._replace(outer_params=self.family[0]), xs, self.cfg
        )
        l_loc = self.cfg.L_out // self.grid.p
        cells = [
            CellState(
                cell.base,
                delta_mod.append_keys(
                    cell.delta, outer_keys[:, c * l_loc : (c + 1) * l_loc], inner_keys, room
                ),
                cell.occ,  # base map untouched; delta keys OR in at query time
            )
            for c, cell in enumerate(node.cells)
        ]
        store, ts = stream_index.scatter_rows(node.store, node.ts, n, node.count, room, xs, t)
        return NodeState(store, ts, cells)

    # ----------------------------------------------------------------- query

    def _node_query(self, node: NodeState, node_id: int, queries: torch.Tensor, pk: torch.Tensor):
        """One node's partials; ``pk`` is ``(p, Q, L_loc, 1+multiprobe)``."""
        kd, ki, comps, over, routed = [], [], [], [], []
        for c, cell in enumerate(node.cells):
            res = pipeline.query_batch(
                cell.base, node.store, queries, self.cfg,
                delta=delta_mod.as_view(cell.delta, cell.base.n),
            )
            if self.route:
                # delta segments inherit the cell's placement: OR the live
                # delta keys' occupancy into the base map, then route
                keys = cell.delta.outer_keys[: cell.delta.count]
                d_occ = routing.delta_occupancy(
                    keys, torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device),
                    self.route_bits, cell.occ.shape[-1],
                )
                hit = routing.route_cell(cell.occ | d_occ, pk[c])
            else:
                hit = torch.ones(queries.shape[0], dtype=torch.bool, device=queries.device)
            kd.append(torch.where(hit[:, None], res.knn_dist, topk.INF))
            ki.append(torch.where(hit[:, None], res.knn_idx, -1))
            comps.append(torch.where(hit, res.comparisons, 0))
            over.append(torch.where(hit, res.compaction_overflow, 0))
            routed.append(hit)
        kd, ki = torch.stack(kd), torch.stack(ki)
        gidx = torch.where(ki >= 0, ki + node_id * self.node_capacity, -1)
        return kd, gidx, torch.stack(comps), torch.stack(over), torch.stack(routed)

    def _query(self, state: list[NodeState], queries: torch.Tensor):
        """``(kd, ki, comparisons, overflow, routed)`` over the node list;
        every cell computes and the route masks, as in the JAX package."""
        q = queries.shape[0]
        l_loc = self.cfg.L_out // self.grid.p
        pk = routing.probe_keys(self.family[0], queries, self.cfg)
        pk = pk.reshape(q, self.grid.p, l_loc, -1).permute(1, 0, 2, 3)  # cell c owns rows [c*L_loc, ...)
        parts = [self._node_query(nd, i, queries, pk) for i, nd in enumerate(state)]
        kd, ki, comps, overflow, routed = (torch.stack([p[f] for p in parts]) for f in range(5))
        kd2 = kd.permute(2, 0, 1, 3).reshape(q, -1)
        ki2 = ki.permute(2, 0, 1, 3).reshape(q, -1)
        # cells of a node share its points: merge unique-by-index so a
        # weighted vote never counts a neighbour twice
        fd, fi = topk.masked_unique_topk_smallest(kd2, ki2, self.cfg.k)
        return fd, fi, comps, overflow, routed

    def query(self, queries) -> D.DistributedQueryResult:
        """Resolve queries against the live sharded index -> typed result."""
        q = _on(queries, self.device)
        kd, ki, comps, overflow, routed = self._query(self.state, q)
        return D.DistributedQueryResult(kd, ki, comps, overflow, routed)

    # ----------------------------------------------------------- maintenance

    def maintain(self, node_idx: int, t: float) -> tuple[int, np.ndarray | None]:
        """Compact (and, under a retention horizon, evict) one node's cells.

        Returns ``(evicted, keep)``: the evicted-window count and — when
        eviction renumbered store rows — the surviving old rows
        (ascending). The keep set and the store rebuild depend only on the
        node's shared timestamps, so they are computed once."""
        node = self.state[node_idx]
        n_tot = node.n + node.count
        keep = None
        if np.isfinite(self.retention_s):
            keep = stream_index.retention_keep(node.ts, n_tot, t - self.retention_s, self.cfg.h_max)
        if keep is not None and keep.shape[0] < n_tot:
            # evict: rebuild each cell's tables over the kept rows (this
            # subsumes compaction); the store renumbers once
            data = node.store[keep]
            cells = [
                _fresh_cell(
                    pipeline.build_from_params(data, c.base.outer_params, c.base.inner_params, self.cfg),
                    self.node_capacity, self.delta_cap, self.cfg, self.route_bits,
                )
                for c in node.cells
            ]
            store, ts = stream_index._store(data, self.node_capacity, node.ts[keep])
            self.state[node_idx] = NodeState(store, ts, cells)
            return n_tot - keep.shape[0], keep.cpu().numpy()
        cells = []
        for c in node.cells:
            s = stream_index.compact(cell_as_stream(c, node), self.cfg)
            cells.append(CellState(
                s.base, s.delta, routing.cell_occupancy(s.base.outer.sorted_keys, s.base.n, self.route_bits)
            ))
        self.state[node_idx] = NodeState(node.store, node.ts, cells)
        return 0, None

    def compact_all(self, t: float = 0.0) -> list[tuple[int, np.ndarray | None]]:
        """Compact every node now; one ``(evicted, keep)`` pair per node."""
        return [self.maintain(i, t) for i in range(self.grid.nu)]

    # ---------------------------------------------------------------- stream

    def ingest(self, points, t: float) -> IngestReport:
        """Route one batch to the next node; auto-compact on pressure.

        Under an ambient obs bundle the call records a ``stream.ingest``
        span (which synchronizes the device, so it times the ingest's
        device work) and the stream metrics; uninstrumented, it does one
        ContextVar check and records nothing."""
        ob = obs_mod.get_active()
        if ob is None or not ob.enabled:
            return self._ingest_impl(points, t)
        with ob.span("stream.ingest", t=float(t)) as sp:
            rep = self._ingest_impl(points, t)
            _sync(self.device)
        if ob.metrics is not None:
            m = ob.metrics
            m.histogram(
                "dslsh_stream_ingest_latency_seconds",
                "wall time of one ShardedStream.ingest (synced)",
            ).observe(sp.dur_s)
            m.counter("dslsh_stream_inserted_total", "windows absorbed into delta segments").inc(rep.inserted)
            m.counter(
                "dslsh_stream_dropped_total", "windows dropped with delta + store both full"
            ).inc(rep.dropped)
            if rep.compacted:
                m.counter("dslsh_stream_compactions_total", "pressure-triggered node compactions").inc()
            m.counter(
                "dslsh_stream_evicted_total", "stale windows evicted by retention during compaction"
            ).inc(rep.evicted)
        return rep

    def _ingest_impl(self, points, t: float) -> IngestReport:
        xs = _on(points, self.device)
        b = xs.shape[0]
        node_idx = self.rr % self.grid.nu
        self.rr += 1

        def room_left() -> tuple[int, int, int]:
            node = self.state[node_idx]
            room = stream_index.delta_room(self.node_capacity, self.delta_cap, node.n)
            return node.n, node.count, room - node.count

        base_n, count, room = room_left()
        compacted, evicted, keep = False, 0, None
        if b > room:
            evicted, keep = self.maintain(node_idx, t)
            compacted = True
            base_n, count, room = room_left()
        self.state[node_idx] = self._insert(self.state[node_idx], xs, float(t))
        inserted = min(b, max(room, 0))
        slots = np.arange(base_n + count, base_n + count + inserted)
        return IngestReport(
            node=node_idx, inserted=inserted, dropped=b - inserted,
            compacted=compacted, evicted=evicted, slots=slots, keep=keep,
        )

    def n_index(self) -> int:
        """Points queryable right now, across all nodes."""
        return sum(nd.n + nd.count for nd in self.state)
