"""DSLSH on a cell grid (counterpart of ``repro.core.distributed``).

The paper's nu nodes each own n/nu points and p cores per node each own
L_out/p outer tables; the Root broadcasts one hash family and each core
keeps its rows of it. Two execution paths share the per-cell functions and
return the one typed :class:`DistributedQueryResult`:

* ``simulate_build`` + ``grid_query``: the nu*p cells as a Python loop on
  one device. The Reducer merges the cells' partial top-Ks in flat
  (node, core) order, so distance ties resolve as in the JAX package; with
  a ``routing.RoutingPlan`` the query is routed, replica-split and
  tournament-merged.
* ``dslsh_build`` + ``mesh_query``: the mesh, one rank per cell over
  ``torch.distributed`` (``launch.mesh``). Nodes are the mesh axis
  ``data``, cores the axis ``model`` and replicas an optional leading
  ``rep``. Every rank builds and queries its own cell on its device; the
  Reducer merges over ``model``, then over ``data``, by all-gather or by
  a ppermute tournament (``merge_axis_allgather``, ``merge_axis_tree``),
  bit-identical to each other including distance ties. On gloo the
  partials cross the host (``sharding.ctx.TRAFFIC``), and
  :data:`REDUCER` keeps the merge's time and bytes.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hashing, pipeline, pknn, routing, topk
from repro_torch.sharding import ctx


@dataclasses.dataclass(frozen=True)
class Grid:
    nu: int  # nodes
    p: int  # cores per node

    @property
    def cells(self) -> int:
        """Total SLSH cells (the paper's nu*p)."""
        return self.nu * self.p


def pad_to_multiple(points, labels, multiple: int, sentinel: float = 1e9):
    """Pad a numpy dataset so n divides the shard grid; pads sit
    ``sentinel``-far away and never enter a K-NN with k <= n real points."""
    n = points.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return points, labels, n
    pad_pts = np.full((rem, points.shape[1]), sentinel, points.dtype)
    pad_lab = np.zeros((rem,), labels.dtype)
    return np.concatenate([points, pad_pts]), np.concatenate([labels, pad_lab]), n


def _local_tables(cfg: pipeline.SLSHConfig, p: int) -> int:
    if cfg.L_out % p:
        raise ValueError(f"L_out={cfg.L_out} must divide across p={p} cores")
    return cfg.L_out // p


def cell_build(
    family: tuple[hashing.BitSampleParams, hashing.SignRPParams],
    data_local: torch.Tensor,
    core_id: int,
    cfg: pipeline.SLSHConfig,
    grid: Grid,
) -> pipeline.SLSHIndex:
    """Build this cell's L_out/p tables over its node's data slice, from
    rows ``[core_id*L_loc, ...)`` of the root family."""
    full, inner = family
    l_loc = _local_tables(cfg, grid.p)
    rows = slice(core_id * l_loc, (core_id + 1) * l_loc)
    outer = hashing.BitSampleParams(full.dims[rows], full.thrs[rows], full.salts[rows])
    return pipeline.build_from_params(data_local, outer, inner, cfg)


class CellResult(NamedTuple):
    knn_dist: torch.Tensor  # (Q, K) partial distances
    knn_idx: torch.Tensor  # (Q, K) GLOBAL indices (-1 pad)
    comparisons: torch.Tensor  # (Q,) unique candidates scanned in this cell
    compaction_overflow: torch.Tensor  # (Q,) survivors beyond c_comp


class DistributedQueryResult(NamedTuple):
    """The typed result every DSLSH query path returns: merged top-K plus
    per-(node, core, query) counters. Single-shard results use nu = p = 1."""

    knn_dist: torch.Tensor  # (Q, K) merged distances, inf pad
    knn_idx: torch.Tensor  # (Q, K) merged GLOBAL indices, -1 pad
    comparisons: torch.Tensor  # (nu, p, Q) unique candidates scanned per cell
    compaction_overflow: torch.Tensor  # (nu, p, Q) survivors beyond c_comp
    routed: torch.Tensor  # (nu, p, Q) bool — (cell, query) pairs visited
    # compressed-payload deployments only (None on the f32 path and on
    # grids): candidates left out of the c_rerank shortlist whose
    # approximate distance came within the quantization error bound of the
    # k-th exact distance — counted, never silent; 0 everywhere certifies
    # knn_idx identical to the f32 tail
    rerank_misses: torch.Tensor | None = None  # (nu, p, Q) int32

    @property
    def routed_frac(self) -> float:
        """Fraction of (cell, query) pairs visited (1.0 = broadcast)."""
        return float(self.routed.to(torch.float32).mean())

    @property
    def rerank_miss_total(self) -> int:
        """Total rerank-margin misses across cells and queries (0 for the
        f32 payload path, which has no shortlist)."""
        if self.rerank_misses is None:
            return 0
        return int(self.rerank_misses.sum())

    @property
    def overflow_cells(self) -> int:
        """(cell, query) partials whose c_comp budget overflowed."""
        return int((self.compaction_overflow > 0).sum())

    @property
    def max_comparisons_per_cell(self) -> torch.Tensor:
        """Per-query max of comparisons over cells — the paper's
        per-processor work metric (its median is the headline number)."""
        return self.comparisons.amax(dim=(0, 1))


def cell_query(
    index: pipeline.SLSHIndex,
    data_local: torch.Tensor,
    node_offset: int,
    queries: torch.Tensor,
    cfg: pipeline.SLSHConfig,
) -> CellResult:
    """Query one cell and lift its neighbour indices to global ones."""
    res = pipeline.query_batch(index, data_local, queries, cfg)
    gidx = torch.where(res.knn_idx >= 0, res.knn_idx + node_offset, -1)
    return CellResult(res.knn_dist, gidx, res.comparisons, res.compaction_overflow)


def simulate_build(
    family: tuple[hashing.BitSampleParams, hashing.SignRPParams],
    data: torch.Tensor,
    cfg: pipeline.SLSHConfig,
    grid: Grid,
) -> list[pipeline.SLSHIndex]:
    """Build every cell on one device -> cell indexes in flat (node, core)
    order."""
    n = data.shape[0]
    if n % grid.nu:
        raise ValueError(f"n={n} does not divide across nu={grid.nu} nodes")
    n_loc = n // grid.nu
    return [
        cell_build(family, data[j * n_loc : (j + 1) * n_loc], c, cfg, grid)
        for j in range(grid.nu)
        for c in range(grid.p)
    ]


def grid_query(
    index: list[pipeline.SLSHIndex],
    data: torch.Tensor,
    queries: torch.Tensor,
    cfg: pipeline.SLSHConfig,
    grid: Grid,
    *,
    plan: routing.RoutingPlan | None = None,
    drop_mask: torch.Tensor | None = None,
    drop_cells: torch.Tensor | None = None,
    max_cells: int | None = None,
    return_stats: bool = False,
):
    """Query every cell, then the Reducer's merge -> typed result.

    With ``plan=None`` the Forwarder broadcasts and the Reducer runs the
    flat masked top-K merge. With a ``routing.RoutingPlan`` the batch is
    hashed once against the full family, routed to the cells its probe
    keys can land in, block-split across each cell's replicas and merged
    by the tournament: equal to the broadcast result in distances,
    indices, comparisons and overflow. As in the JAX package every cell
    computes and the route then masks.

    ``max_cells`` probes only the best-landing cells per query
    (approximate by design; needs a plan). ``drop_mask`` (nu,) excludes
    straggler nodes from the merge; ``drop_cells`` (nu, p) excludes lost
    cells, zeroes their counters and flips them off in ``routed``.
    ``return_stats`` also returns a ``routing.RoutingStats`` (needs a plan).
    """
    if plan is None and (max_cells is not None or return_stats):
        raise ValueError(
            "max_cells / return_stats require a routing plan — build one"
            " with routing.make_plan(index, cfg, grid) (or use a routed"
            " dslsh deployment)"
        )
    n = data.shape[0]
    n_loc = n // grid.nu
    q = queries.shape[0]
    dev = data.device
    parts = [
        cell_query(
            index[j * grid.p + c], data[j * n_loc : (j + 1) * n_loc], j * n_loc,
            queries, cfg,
        )
        for j in range(grid.nu)
        for c in range(grid.p)
    ]

    def stack(field: int) -> torch.Tensor:
        x = torch.stack([part[field] for part in parts])
        return x.reshape((grid.nu, grid.p) + x.shape[1:])

    kd, ki, comps, overflow = (stack(i) for i in range(4))
    if drop_mask is None:
        drop_mask = torch.zeros(grid.nu, dtype=torch.bool, device=dev)
    drop_mask = torch.as_tensor(drop_mask, device=dev)
    if plan is None:
        kd = torch.where(drop_mask[:, None, None, None], topk.INF, kd)
        ki = torch.where(drop_mask[:, None, None, None], -1, ki)
        visited = torch.ones((grid.nu, grid.p, q), dtype=torch.bool, device=dev)
        if drop_cells is not None:
            dc = torch.as_tensor(drop_cells, device=dev)[:, :, None]
            kd = torch.where(dc[..., None], topk.INF, kd)
            ki = torch.where(dc[..., None], -1, ki)
            comps = torch.where(dc, 0, comps)
            overflow = torch.where(dc, 0, overflow)
            visited = visited & ~dc
        kd = kd.permute(2, 0, 1, 3).reshape(q, -1)
        ki = ki.permute(2, 0, 1, 3).reshape(q, -1)
        fd, fi = topk.masked_topk_smallest(kd, ki, cfg.k)
        return DistributedQueryResult(fd, fi, comps, overflow, visited)

    pk = routing.probe_keys(routing.family_from_index(index, grid.p), queries, cfg)
    routed, scores = routing.route_mask(plan.occupancy, pk, grid)
    if max_cells is not None:
        routed = routing.apply_cell_budget(routed, scores, max_cells)
    if drop_cells is not None:
        routed = routed & ~torch.as_tensor(drop_cells, device=dev)[None]
    mask = routed.permute(1, 2, 0)  # (nu, p, Q)
    kd = torch.where(mask[..., None], kd, topk.INF)
    ki = torch.where(mask[..., None], ki, -1)
    comps = torch.where(mask, comps, 0)
    overflow = torch.where(mask, overflow, 0)
    kd = torch.where(drop_mask[:, None, None, None], topk.INF, kd)
    ki = torch.where(drop_mask[:, None, None, None], -1, ki)
    kd_s = kd.reshape(grid.cells, q, cfg.k)
    ki_s = ki.reshape(grid.cells, q, cfg.k)
    if plan.r_max > 1:
        # stage 1: split each cell's partial across its replicas by row
        # block, then reassemble (replicas own disjoint rows)
        owner = torch.as_tensor(
            np.stack([
                routing.replica_owner(q, int(plan.replicas[j, c]))
                for j in range(grid.nu)
                for c in range(grid.p)
            ]),
            device=dev,
        )
        merged = [
            routing.merge_replica_partials(
                *routing.split_replicas(kd_s[s], ki_s[s], owner[s], plan.r_max), cfg.k
            )
            for s in range(grid.cells)
        ]
        kd_s = torch.stack([m[0] for m in merged])
        ki_s = torch.stack([m[1] for m in merged])
    fd, fi = routing.merge_partials_tree(kd_s, ki_s, cfg.k)
    result = DistributedQueryResult(fd, fi, comps, overflow, mask)
    if not return_stats:
        return result
    routed_np = routed.cpu().numpy()
    stats = routing.RoutingStats(
        routed=routed_np,
        scores=scores.cpu().numpy(),
        payload=routing.merge_payload(mask.cpu().numpy().reshape(grid.cells, q), cfg.k),
        device_load=routing.device_load(plan, routed_np),
    )
    return result, stats


def simulate_query(
    index: list[pipeline.SLSHIndex],
    data: torch.Tensor,
    queries: torch.Tensor,
    cfg: pipeline.SLSHConfig,
    grid: Grid,
    drop_mask: torch.Tensor | None = None,
):
    """Deprecated positional-tuple form of the broadcast :func:`grid_query`:
    returns (knn_dist, knn_idx, comparisons, compaction_overflow), the
    ``grid_query`` fields bit for bit."""
    warnings.warn(
        "simulate_query is deprecated: build a repro_torch.dslsh Index"
        " (dslsh.build(..., deploy=dslsh.grid(nu, p))) and call .query(),"
        " or use distributed.grid_query for the typed result",
        DeprecationWarning,
        stacklevel=2,
    )
    res = grid_query(index, data, queries, cfg, grid, drop_mask=drop_mask)
    return res.knn_dist, res.knn_idx, res.comparisons, res.compaction_overflow


def simulate_query_routed(
    index: list[pipeline.SLSHIndex],
    data: torch.Tensor,
    queries: torch.Tensor,
    cfg: pipeline.SLSHConfig,
    grid: Grid,
    plan: routing.RoutingPlan,
    drop_mask: torch.Tensor | None = None,
    max_cells: int | None = None,
    return_stats: bool = False,
):
    """Deprecated positional-tuple form of the routed :func:`grid_query`:
    returns (knn_dist, knn_idx, comparisons, compaction_overflow[, stats])."""
    warnings.warn(
        "simulate_query_routed is deprecated: build a routed repro_torch.dslsh"
        " Index (dslsh.grid(..., routed=True)) and call .query(), or use"
        " distributed.grid_query(plan=...) for the typed result",
        DeprecationWarning,
        stacklevel=2,
    )
    out = grid_query(
        index, data, queries, cfg, grid, plan=plan, drop_mask=drop_mask,
        max_cells=max_cells, return_stats=return_stats,
    )
    res, stats = out if return_stats else (out, None)
    flat = (res.knn_dist, res.knn_idx, res.comparisons, res.compaction_overflow)
    return flat + (stats,) if return_stats else flat


# ------------------------------------------------------------------- mesh

# The Reducer's cost on this rank since the last reset: merged batches,
# seconds from this rank's partial, ready on its device, to the merged
# answer (the collectives' waits for slower ranks included), and the bytes
# its partials crossed between device and host and handed to the transport
REDUCER = {"batches": 0, "seconds": 0.0, "host_copy_bytes": 0, "sent_bytes": 0}


def reset_reducer() -> None:
    """Set the :data:`REDUCER` counters to 0."""
    REDUCER.update(batches=0, seconds=0.0, host_copy_bytes=0, sent_bytes=0)


def _pack(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two tensors as one byte message, so a partial crosses in one
    collective."""
    return torch.cat([a.contiguous().view(-1).view(torch.uint8), b.contiguous().view(-1).view(torch.uint8)])


def _unpack(buf: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """The inverse of :func:`_pack` over ``buf``'s leading dims, with the
    shapes and dtypes of ``a`` and ``b``."""
    lead = tuple(buf.shape[:-1])
    cut = a.numel() * a.element_size()
    return (
        buf[..., :cut].contiguous().view(a.dtype).reshape(lead + tuple(a.shape)),
        buf[..., cut:].contiguous().view(b.dtype).reshape(lead + tuple(b.shape)),
    )


def merge_axis_allgather(mesh: ctx.Mesh, axis: str, kd: torch.Tensor, ki: torch.Tensor, k: int):
    """Reducer via all-gather: (Q, K) -> (Q, K) merged over mesh axis
    ``axis``, the partials taken in axis order."""
    gd, gi = _unpack(ctx.all_gather(mesh, axis, _pack(kd, ki)), kd, ki)  # (S, Q, K)
    s, q = gd.shape[0], kd.shape[0]
    gd = gd.permute(1, 0, 2).reshape(q, s * k)
    gi = gi.permute(1, 0, 2).reshape(q, s * k)
    return topk.masked_topk_smallest(gd, gi, k)


def merge_axis_tree(mesh: ctx.Mesh, axis: str, kd: torch.Tensor, ki: torch.Tensor, k: int):
    """Reducer via a ppermute tournament tree and a broadcast.

    ``routing.tournament_rounds`` gives the (dst, src) exchange schedule:
    sources fold into ascending destinations over ``ceil(log2(size))``
    rounds (ranks of a non-power-of-two axis sit rounds out), rank 0 ends
    with the full merge, and the rounds run reversed broadcast it back.
    The fold visits partials in ascending rank order, so the result equals
    :func:`merge_axis_allgather` bit for bit, ties included. Ranks that
    receive nothing merge with a neutral (inf, -1) partial, as in JAX.
    """
    me = ctx.axis_index(mesh, axis)
    rounds = routing.tournament_rounds(mesh.shape[axis])
    for rnd in rounds:
        pd, pi = _unpack(ctx.ppermute(mesh, axis, _pack(kd, ki), [(src, dst) for dst, src in rnd]), kd, ki)
        if me not in [dst for dst, _ in rnd]:
            pd, pi = torch.full_like(pd, topk.INF), torch.full_like(pi, -1)
        kd, ki = topk.merge_topk(kd, ki, pd, pi, k)
    for rnd in reversed(rounds):  # holders push one level down
        bd, bi = _unpack(ctx.ppermute(mesh, axis, _pack(kd, ki), list(rnd)), kd, ki)
        if me in [src for _, src in rnd]:
            kd, ki = bd, bi
    return kd, ki


def node_rows(mesh: ctx.Mesh, data, grid: Grid) -> torch.Tensor:
    """This rank's node's rows of the dataset ``data`` (n, d), as float32
    on the mesh's device. ``data`` may be a memory-mapped numpy array:
    only the node's block is read."""
    n = data.shape[0]
    if n % grid.nu:
        raise ValueError(f"n={n} does not divide across nu={grid.nu} nodes")
    n_loc = n // grid.nu
    node = ctx.axis_index(mesh, "data")
    rows = data[node * n_loc : (node + 1) * n_loc]
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.array(rows, dtype=np.float32))
    return rows.to(device=mesh.device, dtype=torch.float32).contiguous()


def dslsh_build(
    mesh: ctx.Mesh,
    family: tuple[hashing.BitSampleParams, hashing.SignRPParams],
    data: torch.Tensor,
    cfg: pipeline.SLSHConfig,
    grid: Grid,
) -> pipeline.SLSHIndex:
    """Build this rank's cell over ``data``, its node's rows
    (:func:`node_rows`, the rank's shard of JAX's row-sharded dataset),
    from its core's ``L_out/p`` rows of the root ``family``, which every
    rank must hold alike (the Root's broadcast)."""
    return cell_build(family, data, ctx.axis_index(mesh, "model"), cfg, grid)


def mesh_family(mesh: ctx.Mesh, cell: pipeline.SLSHIndex) -> hashing.BitSampleParams:
    """The full outer family, gathered from the slices the cells of this
    rank's node hold (over ``model``, in core order)."""
    return hashing.BitSampleParams(*(
        g.reshape((-1,) + tuple(g.shape[2:]))
        for g in (ctx.all_gather(mesh, "model", f) for f in cell.outer_params)
    ))


def mesh_query(
    mesh: ctx.Mesh,
    index: pipeline.SLSHIndex,
    data: torch.Tensor,
    queries: torch.Tensor,
    cfg: pipeline.SLSHConfig,
    grid: Grid,
    reducer: str = "allgather",
    drop_mask=None,
    plan: routing.RoutingPlan | None = None,
    max_cells: int | None = None,
    family: hashing.BitSampleParams | None = None,
) -> DistributedQueryResult:
    """Resolve a query batch on the mesh; every rank calls it with its own
    cell ``index`` and node rows ``data``, and the same ``queries``.

    Returns the same :class:`DistributedQueryResult` on every rank: the
    merged ``(Q, K)`` top-K and the counters gathered to ``(nu, p, Q)``.
    ``drop_mask`` (nu,) bool marks nodes dropped by the straggler deadline:
    the Reducer proceeds without their partials. ``plan`` routes each query
    only to the cells its probe keys can land in (every rank hashes the
    batch against the full ``family``, gathered from the cells when not
    given, and masks its partial by its slice of the route mask);
    ``max_cells`` caps the probed cells per query (approximate by design).
    On a mesh with a ``rep`` axis the batch is row-split over the
    replicas (``Q % rep == 0``); each replica merges its row block over
    the cells, and the blocks are reassembled in rep order.
    """
    if reducer not in ("allgather", "tree"):
        raise ValueError(f"unknown reducer {reducer!r}; one of ('allgather', 'tree')")
    dev = data.device
    q = queries.shape[0]
    r = mesh.shape.get("rep", 1)
    if q % r:
        raise ValueError(f"a batch of {q} queries does not divide across the rep axis ({r})")
    if plan is not None:
        fam = family if family is not None else mesh_family(mesh, index)
        pk = routing.probe_keys(fam, queries, cfg)
        routed, scores = routing.route_mask(plan.occupancy, pk, grid)
        if max_cells is not None:
            routed = routing.apply_cell_budget(routed, scores, max_cells)
    else:
        routed = torch.ones((q, grid.nu, grid.p), dtype=torch.bool, device=dev)
    node, core = ctx.axis_index(mesh, "data"), ctx.axis_index(mesh, "model")
    rep = ctx.axis_index(mesh, "rep") if "rep" in mesh.shape else 0
    rows = slice(rep * (q // r), (rep + 1) * (q // r))
    res = cell_query(index, data, node * data.shape[0], queries[rows], cfg)
    r_q = routed[rows, node, core]  # this cell's slice of the route mask
    kd = torch.where(r_q[:, None], res.knn_dist, topk.INF)
    ki = torch.where(r_q[:, None], res.knn_idx, -1)
    comps = torch.where(r_q, res.comparisons, 0)
    overflow = torch.where(r_q, res.compaction_overflow, 0)
    if drop_mask is not None and bool(torch.as_tensor(drop_mask)[node]):
        kd, ki = torch.full_like(kd, topk.INF), torch.full_like(ki, -1)

    # the Master: merge within the node (over cores), then across nodes
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0, before = time.perf_counter(), dict(ctx.TRAFFIC)
    merge = merge_axis_tree if reducer == "tree" else merge_axis_allgather
    kd, ki = merge(mesh, "model", kd, ki, cfg.k)
    kd, ki = merge(mesh, "data", kd, ki, cfg.k)
    if "rep" in mesh.shape:
        # replicas own disjoint contiguous row blocks: reassemble in order
        kd, ki = _unpack(ctx.all_gather(mesh, "rep", _pack(kd, ki)), kd, ki)
        kd, ki = kd.reshape(-1, kd.shape[-1]), ki.reshape(-1, ki.shape[-1])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    REDUCER["batches"] += 1
    REDUCER["seconds"] += time.perf_counter() - t0
    for key in ("host_copy_bytes", "sent_bytes"):
        REDUCER[key] += ctx.TRAFFIC[key] - before[key]

    counters = _pack(comps, overflow)
    for axis in ("model", "data") + (("rep",) if "rep" in mesh.shape else ()):
        counters = ctx.all_gather(mesh, axis, counters)
    if "rep" not in mesh.shape:
        counters = counters[None]
    comps, overflow = (
        c.permute(1, 2, 0, 3).reshape(grid.nu, grid.p, q)
        for c in _unpack(counters, comps, overflow)
    )
    return DistributedQueryResult(kd, ki, comps, overflow, routed.permute(1, 2, 0))


def dslsh_query(
    mesh: ctx.Mesh,
    index: pipeline.SLSHIndex,
    data: torch.Tensor,
    queries: torch.Tensor,
    cfg: pipeline.SLSHConfig,
    grid: Grid,
    reducer: str = "allgather",
    drop_mask=None,
    plan: routing.RoutingPlan | None = None,
    max_cells: int | None = None,
):
    """Deprecated positional-tuple form of :func:`mesh_query`: returns
    (knn_dist, knn_idx, comparisons, compaction_overflow)."""
    warnings.warn(
        "dslsh_query is deprecated: build a repro_torch.dslsh Index"
        " (dslsh.build(..., deploy=dslsh.mesh(...))) and call .query(), or"
        " use distributed.mesh_query for the typed result",
        DeprecationWarning,
        stacklevel=2,
    )
    res = mesh_query(
        mesh, index, data, queries, cfg, grid, reducer=reducer,
        drop_mask=drop_mask, plan=plan, max_cells=max_cells,
    )
    return res.knn_dist, res.knn_idx, res.comparisons, res.compaction_overflow


def pknn_query(
    data: torch.Tensor, queries: torch.Tensor, k: int, grid: Grid
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Data-parallel exhaustive l1 K-NN baseline (the paper's PKNN): every
    processor scans n/(p*nu) points; evaluated on one device."""
    kd, ki = pknn.knn_batch(data, queries.to(torch.float32), k)
    comps = torch.full(
        (grid.nu, grid.p, queries.shape[0]), data.shape[0] // grid.cells,
        dtype=torch.int32, device=data.device,
    )
    return kd, ki, comps
