"""The two deployments over plain cells: the paper's grid of ``nu`` nodes by
``p`` cores, and the streaming grid whose nodes take batches round-robin.

Grid: node ``j`` holds rows ``[j * n_loc, (j + 1) * n_loc)`` of the data and
core ``c`` of it the tables ``[c * L_loc, (c + 1) * L_loc)`` of the
bit-sampling family; a row's global index is ``j * n_loc + row``. The
answer is the k nearest of all cells' partial answers taken in (node,
core) order, a row two cores of a node both found counted twice, as the
paper's Reducer merges.

Streaming: node ``j`` starts with the same rows, its global index is ``j *
node_capacity + row``, and each ingested batch goes to the next node in
turn. A node whose delta segment cannot take the batch (``min(delta_cap,
node_capacity - base rows)`` slots) compacts first: every row becomes
base. What does not fit then is dropped. The answer is the k nearest over
all cells with each row counted once.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from bench.reference import dslsh


def query_keys(queries: torch.Tensor, outer: dict, inner: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The queries' keys for every table of the root family."""
    return (dslsh.outer_keys(queries, outer["dims"], outer["thrs"], outer["salts"]),
            dslsh.inner_keys(queries, inner["proj"], inner["salts"]))


def grid_answer(data: torch.Tensor, outer: dict, inner: dict, cfg: dict, nu: int, p: int,
                queries: torch.Tensor,
                on_cell: Callable[[int, int, dslsh.Cell], None] | None = None
                ) -> tuple[dslsh.Answer, torch.Tensor]:
    """The grid's merged answer and its comparisons (nu, p, Q). Cells are
    built one at a time; ``on_cell(node, core, cell)`` sees each before it is
    dropped."""
    n_loc = data.shape[0] // nu
    l_loc = cfg["L_out"] // p
    qk, qi = query_keys(queries, outer, inner)
    parts, comps = [], []
    for j in range(nu):
        rows = data[j * n_loc : (j + 1) * n_loc]
        for c in range(p):
            cell = dslsh.build_cell(rows, dslsh.cell_tables(outer, c, l_loc), inner, cfg)
            if on_cell is not None:
                on_cell(j, c, cell)
            ans = dslsh.query_cell(cell, rows, queries, qk[:, c * l_loc : (c + 1) * l_loc], qi, cfg, n_loc)
            ans.idx = torch.where(ans.idx >= 0, ans.idx + j * n_loc, -1)
            parts.append(ans)
            comps.append(ans.comparisons)
            del cell
    return dslsh.merge(parts, cfg["k"]), torch.stack(comps).reshape(nu, p, -1)


class StreamState:
    """Which rows each streaming node holds, and how many are base."""

    def __init__(self, warm: torch.Tensor, warm_labels: torch.Tensor, nu: int, p: int,
                 node_capacity: int, delta_cap: int):
        n_loc = warm.shape[0] // nu
        self.nu, self.p, self.capacity, self.delta_cap = nu, p, node_capacity, delta_cap
        self.chunks = [[warm[j * n_loc : (j + 1) * n_loc]] for j in range(nu)]
        self.label_chunks = [[warm_labels[j * n_loc : (j + 1) * n_loc]] for j in range(nu)]
        self.base_n = [n_loc] * nu
        self.count = [0] * nu
        self.rr = 0

    def compact(self, j: int) -> None:
        """Make node ``j``'s delta rows base."""
        self.base_n[j] += self.count[j]
        self.count[j] = 0

    def ingest(self, xs: torch.Tensor, ys: torch.Tensor) -> None:
        """Route one batch to the next node."""
        j = self.rr % self.nu
        self.rr += 1
        b = xs.shape[0]

        def room() -> int:
            return min(self.delta_cap, self.capacity - self.base_n[j]) - self.count[j]

        if b > room():
            self.compact(j)
        fit = max(0, min(b, room()))
        self.chunks[j].append(xs[:fit])
        self.label_chunks[j].append(ys[:fit])
        self.count[j] += fit

    def snapshot(self) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """(base rows, delta rows) of every node right now."""
        return tuple(self.base_n), tuple(self.count)

    def rows(self, j: int) -> torch.Tensor:
        """Node ``j``'s rows so far (base, then delta)."""
        if len(self.chunks[j]) > 1:
            self.chunks[j] = [torch.cat(self.chunks[j])]
        return self.chunks[j][0]

    def labels(self) -> torch.Tensor:
        """Labels by global index (``node * node_capacity + row``); rows not
        held read 0."""
        dev = self.chunks[0][0].device
        out = torch.zeros((self.nu * self.capacity,), dtype=torch.int64, device=dev)
        for j in range(self.nu):
            lab = torch.cat(self.label_chunks[j])
            out[j * self.capacity : j * self.capacity + lab.shape[0]] = lab.to(torch.int64)
        return out


def stream_cells(state: StreamState, snap, outer: dict, inner: dict, cfg: dict, cache: dict):
    """``(node, core, rows, cell, delta)`` of every cell as the nodes stood at
    ``snap`` (a :meth:`StreamState.snapshot`): the node's rows (base, then
    delta), the cell over its base rows (kept in ``cache`` by node, core and
    base rows) and the delta rows' keys for the cell's tables."""
    base_n, count = snap
    l_loc = cfg["L_out"] // state.p
    for j in range(state.nu):
        rows = state.rows(j)[: base_n[j] + count[j]]
        new = rows[base_n[j] :]
        d_in = dslsh.inner_keys(new, inner["proj"], inner["salts"])
        for c in range(state.p):
            tabs = dslsh.cell_tables(outer, c, l_loc)
            key = (j, c, base_n[j])
            if key not in cache:
                cache[key] = dslsh.build_cell(rows[: base_n[j]], tabs, inner, cfg)
            delta = {"outer": dslsh.outer_keys(new, tabs["dims"], tabs["thrs"], tabs["salts"]), "inner": d_in}
            yield j, c, rows, cache[key], delta


def stream_answer(state: StreamState, snap, outer: dict, inner: dict, cfg: dict, queries: torch.Tensor,
                  cache: dict) -> tuple[dslsh.Answer, torch.Tensor]:
    """The merged answer and comparisons (nu, p, Q) of the nodes as they
    stood at ``snap``."""
    l_loc = cfg["L_out"] // state.p
    qk, qi = query_keys(queries, outer, inner)
    parts, comps = [], []
    for j, c, rows, cell, delta in stream_cells(state, snap, outer, inner, cfg, cache):
        ans = dslsh.query_cell(cell, rows, queries, qk[:, c * l_loc : (c + 1) * l_loc], qi, cfg,
                               state.capacity, delta)
        ans.idx = torch.where(ans.idx >= 0, ans.idx + j * state.capacity, -1)
        parts.append(ans)
        comps.append(ans.comparisons)
    return dslsh.merge(parts, cfg["k"], unique=True), torch.stack(comps).reshape(state.nu, state.p, -1)
