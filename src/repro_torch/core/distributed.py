"""DSLSH on the simulated cell grid (counterpart of ``repro.core.distributed``,
single-device grid only).

The paper's nu nodes each own n/nu points and p cores per node each own
L_out/p outer tables; the Root broadcasts one hash family and each core
keeps its rows of it. Here the nu*p cells are a Python loop on one device,
each cell running the shared pipeline; the Reducer merges the cells'
partial top-Ks in flat (node, core) order, so distance ties resolve as in
the JAX package. The mesh path (``torch.distributed``) and routing are
still to port.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hashing, pipeline, pknn, topk


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
    plan=None,
    drop_mask: torch.Tensor | None = None,
    drop_cells: torch.Tensor | None = None,
) -> DistributedQueryResult:
    """Query every cell, then the Reducer's flat masked top-K merge.

    ``drop_mask`` (nu,) excludes straggler nodes from the merge;
    ``drop_cells`` (nu, p) excludes lost cells, zeroes their counters and
    flips them off in ``routed``. ``plan`` (routing) is still to port.
    """
    if plan is not None:
        raise NotImplementedError(
            "routed grid queries are not ported yet (see ROADMAP.md)"
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
