"""Replication-aware distributed query routing (DESIGN.md §10).

Counterpart of ``repro.core.routing``. The paper's Forwarder broadcasts
every query to every cell and the Reducer merges a flat gather of partial
top-Ks. Three pieces remove that wall:

* **Key→cell map** (:func:`key_cell_map`, :func:`cell_occupancy`): a
  per-(node, table) coarse occupancy bitmap of the CSR keys. A query is
  routed only to the cells one of its probe keys can land in; an
  unoccupied coarse slot proves the key is absent, so routing never
  changes a result bit.
* **Replication plan** (:func:`make_plan`): hot cells (heavy-bucket mass)
  get up to ``r`` replicas on a logical device pool, and a query batch
  block-splits across each cell's replicas.
* **Tournament merge** (:func:`merge_partials_tree`): partial top-Ks merge
  through (dst, src) rounds that visit partials in ascending cell order,
  so the result equals the flat merge bit for bit, ties included.

Deadline degradation maps a latency budget to a cap on the cells probed
per query (:func:`degrade_max_cells`, :func:`apply_cell_budget`).

Bucket keys are int64 holding 32-bit values (``core/hashing.py``); a
coarse slot is the key's high ``bits`` bits. The placement fields of a
plan, the tournament schedule and the accounting stay numpy on the host,
as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hashing, pipeline, topk

DEFAULT_BITS = 12  # coarse key-map slots per table = 2**bits


# ------------------------------------------------------------- key→cell map


def coarse_slot(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """Coarse map slot of each 32-bit bucket key (its ``bits`` high bits),
    as int64; the key is masked to 32 bits before the shift."""
    return (keys & hashing.MASK32) >> (32 - bits)


def _mark(target: torch.Tensor, b: int) -> torch.Tensor:
    """``(..., rows)`` slots (``b`` = dropped) -> ``(..., b)`` occupancy."""
    occ = torch.zeros(target.shape[:-1] + (b + 1,), dtype=torch.bool, device=target.device)
    occ.scatter_(-1, target, True)
    return occ[..., :b]


def key_cell_map(
    sorted_keys: torch.Tensor, n_valid, bits: int = DEFAULT_BITS
) -> torch.Tensor:
    """Coarse occupancy map of cell-stacked CSR keys.

    ``sorted_keys`` is ``(nu, p, L_loc, rows)`` and ``n_valid`` ``(nu, p)``
    the live row count per cell (rows past it are capacity padding and
    mark nothing). Returns ``(nu, L_out, 2**bits)`` bool, table-major:
    table ``t`` of the family is row ``t`` whichever core owns it.
    """
    nu, p, l_loc, rows = sorted_keys.shape
    b = 1 << bits
    n_valid = torch.as_tensor(n_valid, device=sorted_keys.device)
    valid = torch.arange(rows, device=sorted_keys.device) < n_valid[:, :, None, None]
    target = torch.where(valid, coarse_slot(sorted_keys, bits), b)
    return _mark(target, b).reshape(nu, p * l_loc, b)


def delta_occupancy(
    outer_keys: torch.Tensor, valid: torch.Tensor, bits: int, b: int
) -> torch.Tensor:
    """Coarse occupancy of one cell's delta segment: ``(L_loc, b)`` bool.

    A delta segment inherits its cell's placement: its live keys are OR-ed
    into the cell's build-time map at query time, so routing stays exact
    between compactions. ``outer_keys`` is the ``(cap, L_loc)`` key matrix,
    ``valid`` its slot mask.
    """
    target = torch.where(valid[:, None], coarse_slot(outer_keys, bits), b)
    return _mark(target.T.contiguous(), b)


def cell_occupancy(
    sorted_keys: torch.Tensor, n_valid: int, bits: int = DEFAULT_BITS
) -> torch.Tensor:
    """Coarse occupancy of one cell's tables ``(L_loc, rows)``:
    ``(L_loc, 2**bits)`` bool; rows past ``n_valid`` mark nothing."""
    b = 1 << bits
    return _mark(coarse_slot(sorted_keys[:, :n_valid], bits), b)


def route_cell(occ: torch.Tensor, pk_cell: torch.Tensor) -> torch.Tensor:
    """``(Q,)`` bool: does any of a query's probe keys ``(Q, L_loc, P)`` land
    in an occupied coarse slot of this cell's map ``(L_loc, B)``?"""
    bits = occ.shape[-1].bit_length() - 1
    slots = coarse_slot(pk_cell, bits)
    rows = torch.arange(occ.shape[0], device=occ.device)[None, :, None]
    return occ[rows, slots].flatten(1).any(dim=1)


def family_from_index(index, p: int = 1) -> hashing.BitSampleParams:
    """The full outer family of an index: an ``SLSHIndex``'s own params, or
    the concatenated slices of node 0's ``p`` cells of a grid's flat
    (node, core) list (every cell slices the same root family)."""
    if isinstance(index, pipeline.SLSHIndex):
        return index.outer_params
    parts = [cell.outer_params for cell in index[:p]]
    return hashing.BitSampleParams(*(torch.cat(f, dim=0) for f in zip(*parts)))


def probe_keys(
    params: hashing.BitSampleParams, queries: torch.Tensor, cfg
) -> torch.Tensor:
    """All probe keys of a query batch: ``(Q, L_out, 1 + multiprobe)``,
    from the configured backend's signatures (the keys each cell derives
    from its own family slice, bit for bit)."""
    backend = pipeline.get_backend(cfg.backend)
    words = backend.signature_words(params, queries)
    return hashing.probe_keys_from_words(params, queries, words, cfg.multiprobe)


# ------------------------------------------------------------ routing plan


class RoutingPlan(NamedTuple):
    """Build-time routing state: the occupancy map on the index's device,
    the placement fields as host numpy."""

    occupancy: torch.Tensor  # (nu, L_out, 2**bits) bool key→cell map
    replicas: np.ndarray  # (nu, p) int32 replica count per cell, >= 1
    heat: np.ndarray  # (nu, p) float32 heavy-bucket mass driving placement
    cell_device: np.ndarray  # (nu, p, r_max) int32 device ids, -1 pad

    @property
    def bits(self) -> int:
        """Coarse key-map resolution (slots per table = ``2**bits``)."""
        return int(self.occupancy.shape[-1]).bit_length() - 1

    @property
    def r_max(self) -> int:
        """Largest replica count any cell was assigned."""
        return int(self.cell_device.shape[-1])

    @property
    def n_devices(self) -> int:
        """Size of the logical device pool (``sum(replicas)``)."""
        return int(self.cell_device.max()) + 1


def deal_devices(replicas: np.ndarray) -> np.ndarray:
    """Sequential logical-device ids for every cell replica, dealt in
    ascending cell order: ``(nu, p)`` counts -> ``(nu, p, r_max)`` ids, -1
    pad.

    >>> deal_devices(np.asarray([[2, 1]])).tolist()
    [[[0, 1], [2, -1]]]
    """
    replicas = np.asarray(replicas, np.int32)
    nu, p = replicas.shape
    r_max = int(replicas.max())
    cell_device = np.full((nu, p, r_max), -1, np.int32)
    dev = 0
    for j in range(nu):
        for c in range(p):
            for r in range(int(replicas[j, c])):
                cell_device[j, c, r] = dev
                dev += 1
    return cell_device


def make_plan(index, cfg, grid, *, replication: int = 1, bits: int = DEFAULT_BITS) -> RoutingPlan:
    """Routing plan for a grid's flat (node, core) list of cell indexes.

    A cell's heat is its heavy-bucket mass; cells at or above the grid mean
    get ``replication`` replicas, the rest one.
    """
    occ = torch.stack([cell_occupancy(c.outer.sorted_keys, c.n, bits) for c in index])
    occupancy = occ.reshape(grid.nu, grid.p * occ.shape[1], occ.shape[2])
    heat = np.asarray(
        [float((c.heavy.size * c.heavy.valid).sum()) for c in index], np.float32
    ).reshape(grid.nu, grid.p)
    replicas = np.ones((grid.nu, grid.p), np.int32)
    if replication > 1:
        replicas[heat >= heat.mean()] = replication
    return RoutingPlan(occupancy, replicas, heat, deal_devices(replicas))


def replan(plan: RoutingPlan, replicas: np.ndarray) -> RoutingPlan:
    """A plan with explicit per-cell replica counts (elastic rebalance):
    same occupancy and heat, the device pool dealt anew. Answers do not
    change; only where a cell's rows are answered does."""
    replicas = np.asarray(replicas, np.int32)
    if replicas.shape != plan.replicas.shape:
        raise ValueError(
            f"replicas shape {replicas.shape} != plan grid {plan.replicas.shape}"
        )
    if (replicas < 1).any():
        raise ValueError("every cell needs at least one replica")
    return RoutingPlan(plan.occupancy, replicas.copy(), plan.heat, deal_devices(replicas))


def live_replicas(plan: RoutingPlan, device_down: np.ndarray) -> np.ndarray:
    """Live replica count per cell ``(nu, p)`` under a ``(n_devices,)``
    drop mask: ``live == 0`` means the cell is lost and must be dropped
    flagged, never silently (DESIGN.md §14)."""
    down = np.asarray(device_down, bool)
    dev = plan.cell_device
    alive = (dev >= 0) & ~down[np.clip(dev, 0, None)]
    return alive.sum(axis=-1).astype(np.int32)


def route_mask(
    occupancy: torch.Tensor, pk: torch.Tensor, grid
) -> tuple[torch.Tensor, torch.Tensor]:
    """Which cells each query must visit: ``routed (Q, nu, p)`` bool, and
    ``scores (Q, nu, p)`` int32, the count of the cell's tables a probe key
    landed in (the degradation priority). ``pk`` is ``(Q, L_out, P)``."""
    l_out = occupancy.shape[1]
    slots = coarse_slot(pk, occupancy.shape[-1].bit_length() - 1)  # (Q, L, P)
    rows = torch.arange(l_out, device=pk.device)[None, :, None]
    hit = occupancy[:, rows, slots]  # (nu, Q, L, P)
    landed = hit.any(dim=-1).permute(1, 0, 2)  # (Q, nu, L)
    scores = landed.reshape(landed.shape[0], grid.nu, grid.p, l_out // grid.p).sum(-1)
    scores = scores.to(torch.int32)
    return scores > 0, scores


def apply_cell_budget(
    routed: torch.Tensor, scores: torch.Tensor, max_cells: int
) -> torch.Tensor:
    """Probe at most ``max_cells`` cells per query: the routed cells with
    the highest landing scores, ties to the lower cell id."""
    q, nu, p = routed.shape
    s = nu * p
    if max_cells >= s:
        return routed
    flat_r = routed.reshape(q, s)
    flat_s = scores.reshape(q, s).to(torch.int64)
    ids = torch.arange(s, device=routed.device)
    # lexicographic priority (score desc, cell id asc), each one distinct;
    # -1 marks unrouted
    prio = torch.where(flat_r, flat_s * (s + 1) + (s - ids), -1)
    top, pos = torch.sort(prio, dim=1, descending=True, stable=True)
    top, pos = top[:, :max_cells], pos[:, :max_cells]
    keep = torch.zeros((q, s + 1), dtype=torch.bool, device=routed.device)
    keep.scatter_(1, torch.where(top > -1, pos, s), True)
    return keep[:, :s].reshape(q, nu, p)


def degrade_max_cells(
    budget_s: float, levels: tuple[tuple[float, int | None], ...]
) -> int | None:
    """Map a remaining-latency budget to a probe-cell cap: the first
    ``(min_budget_s, max_cells)`` level the budget meets, else the last.

    >>> levels = ((0.05, None), (0.01, 2))
    >>> degrade_max_cells(0.2, levels) is None
    True
    >>> degrade_max_cells(0.02, levels)
    2
    >>> degrade_max_cells(-1.0, levels)
    2
    """
    for thr, cells in levels:
        if budget_s >= thr:
            return cells
    return levels[-1][1]


# ------------------------------------------------------- tree-merge topology


def tournament_rounds(size: int) -> list[list[tuple[int, int]]]:
    """(dst, src) merge pairs per round; rank 0 ends with the full merge,
    having folded partials in ascending rank order.

    >>> tournament_rounds(5)
    [[(0, 1), (2, 3)], [(0, 2)], [(0, 4)]]
    >>> tournament_rounds(1)
    []
    """
    rounds, step = [], 1
    while step < size:
        rounds.append([(d, d + step) for d in range(0, size, 2 * step) if d + step < size])
        step *= 2
    return rounds


def _merge2(kd_a, ki_a, kd_b, ki_b, k: int):
    """Merge two (Q, K) partial top-Ks; ``a`` entries win distance ties."""
    return topk.merge_topk(kd_a, ki_a, kd_b, ki_b, k)


def merge_partials_flat(kd: torch.Tensor, ki: torch.Tensor, k: int):
    """Flat Reducer baseline: all ``(S, Q, K)`` partials in one top-k."""
    s, q, kk = kd.shape
    fd = kd.permute(1, 0, 2).reshape(q, s * kk)
    fi = ki.permute(1, 0, 2).reshape(q, s * kk)
    return topk.masked_topk_smallest(fd, fi, k)


def merge_partials_tree(kd: torch.Tensor, ki: torch.Tensor, k: int):
    """Tournament merge of ``(S, Q, K)`` partials -> ``(Q, K)``, equal to
    :func:`merge_partials_flat` bit for bit."""
    parts_d = list(kd.unbind(0))
    parts_i = list(ki.unbind(0))
    for rnd in tournament_rounds(kd.shape[0]):
        for dst, src in rnd:
            parts_d[dst], parts_i[dst] = _merge2(
                parts_d[dst], parts_i[dst], parts_d[src], parts_i[src], k
            )
    return parts_d[0], parts_i[0]


# ------------------------------------------------------------- replication


def replica_owner(n_queries: int, r: int) -> np.ndarray:
    """Block owner of each query row under an ``r``-way replica split.

    >>> replica_owner(5, 2).tolist()
    [0, 0, 0, 1, 1]
    >>> replica_owner(4, 1).tolist()
    [0, 0, 0, 0]
    """
    blk = -(-n_queries // r)
    return np.minimum(np.arange(n_queries) // blk, r - 1).astype(np.int32)


def split_replicas(kd: torch.Tensor, ki: torch.Tensor, owner: torch.Tensor, r_max: int):
    """Split one cell's (Q, K) partial across its replicas by row owner."""
    reps = torch.arange(r_max, device=kd.device)[:, None]
    mine = owner[None, :] == reps  # (r_max, Q)
    kd_r = torch.where(mine[..., None], kd[None], topk.INF)
    ki_r = torch.where(mine[..., None], ki[None], -1)
    return kd_r, ki_r


def merge_replica_partials(kd_r: torch.Tensor, ki_r: torch.Tensor, k: int):
    """Stage-1 merge: reassemble a cell's partial from its replicas (a real
    top-k merge, though replicas own disjoint rows)."""
    kd, ki = kd_r[0], ki_r[0]
    for i in range(1, kd_r.shape[0]):
        kd, ki = _merge2(kd, ki, kd_r[i], ki_r[i], k)
    return kd, ki


# ------------------------------------------------------------- cost model


class RoutingStats(NamedTuple):
    """Per-batch routing observability (host numpy): the route mask and
    landing counts, the Reducer payload accounting and the routed-row
    load per logical device."""

    routed: np.ndarray  # (Q, nu, p) bool
    scores: np.ndarray  # (Q, nu, p) int32 landed-table counts
    payload: dict  # merge_payload() output
    device_load: np.ndarray  # (n_devices,) int64 routed rows per device


def merge_payload(routed_rows: np.ndarray, k: int, *, bytes_per_entry: int = 8) -> dict:
    """Reducer payload accounting for one batch: the tree merge sends, per
    tournament edge, only the rows where the source subtree holds a routed
    partial (plus a Q-bit row bitmap); the flat baselines move full
    partials. ``routed_rows`` is ``(S, Q)`` bool."""
    routed_rows = np.asarray(routed_rows, bool)
    s, q = routed_rows.shape
    active = routed_rows.copy()
    tree = 0
    for rnd in tournament_rounds(s):
        for dst, src in rnd:
            tree += int(active[src].sum()) * k * bytes_per_entry + (q + 7) // 8
            active[dst] |= active[src]
    master = s * q * k * bytes_per_entry  # idealized master collect
    return dict(
        tree_routed_bytes=tree,
        flat_master_bytes=master,
        flat_allgather_bytes=s * master,
        routed_pairs=int(routed_rows.sum()),
        total_pairs=s * q,
    )


def device_load(plan: RoutingPlan, routed: np.ndarray) -> np.ndarray:
    """Routed query rows per logical device; ``routed`` is ``(Q, nu, p)``
    and each cell's rows block-split across its replicas."""
    routed = np.asarray(routed, bool)
    q = routed.shape[0]
    load = np.zeros((plan.n_devices,), np.int64)
    for j in range(plan.replicas.shape[0]):
        for c in range(plan.replicas.shape[1]):
            r = int(plan.replicas[j, c])
            owner = replica_owner(q, r)
            rows = routed[:, j, c]
            for rep in range(r):
                load[plan.cell_device[j, c, rep]] += int(rows[owner == rep].sum())
    return load
