"""The numbers that decide ``correct``: what the program produced, held to
the plain reference (``bench/reference``), each against its limit.

* ``dist_gap``: the largest relative gap, over every neighbour slot, between
  the program's distance and the reference's float64 distance (1 mmHg
  floors the denominator).
* ``idx_unmatched``: neighbour slots where the program's row is not the
  reference's and is not a tie: its true distance (float64, from the inputs)
  differs from the reference's distance at that slot by more than
  ``TIE_RTOL`` of it, or one side pads where the other holds a row, or the
  program repeats a row more often than the reference does.
* ``comparisons_off``: (cell, query) pairs whose count of distinct
  candidates differs from the reference's.
* ``votes_off``: queries whose AHE vote differs from the reference's vote over
  the program's own neighbours.
* ``tables_off``: entries of the index state (outer keys and rows, heavy
  buckets, inner keys and rows, delta keys) that differ from the
  reference's.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from bench.reference import dslsh

# two float32 sums of 30 terms of a few mmHg differ by well under 1e-6 of the
# total; rows nearer than this share of the distance count as tied
TIE_RTOL = 1e-5


def knn_numbers(prog_dist: torch.Tensor, prog_idx: torch.Tensor, ref: dslsh.Answer,
                true_dist: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> dict:
    """``dist_gap`` and ``idx_unmatched`` of a (Q, k) answer; ``true_dist(rows,
    idx)`` gives the float64 L1 distance of query ``rows`` to rows ``idx``."""
    dev = ref.dist.device
    pd, pi = prog_dist.to(dev, torch.float64), prog_idx.to(dev, torch.int64)
    rd, ri = ref.dist, ref.idx
    ppad, rpad = pi < 0, ri < 0
    both = ~ppad & ~rpad
    rel = (pd - rd).abs() / rd.clamp(min=1.0)
    gap = float(rel[both].max()) if bool(both.any()) else 0.0
    differ = both & (pi != ri)
    rows, cols = differ.nonzero(as_tuple=True)
    untied = 0
    if rows.numel():
        t = true_dist(rows, pi[rows, cols])
        r = rd[rows, cols]
        untied = int(((t - r).abs() > TIE_RTOL * r.clamp(min=1.0)).sum())
    extra = int((_repeats(pi) - _repeats(ri)).clamp(min=0).sum())
    return {"dist_gap": gap, "idx_unmatched": int((ppad != rpad).sum()) + untied + extra}


def _repeats(idx: torch.Tensor) -> torch.Tensor:
    srt = idx.sort(dim=1).values
    return ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum(dim=1)


def l1_of(rows_x: torch.Tensor, queries: torch.Tensor) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``true_dist`` over rows ``rows_x`` indexed by global index."""
    def dist(q_rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        a = rows_x[idx.to(rows_x.device)].to(torch.float64)
        b = queries[q_rows.to(queries.device)].to(torch.float64)
        return (a - b).abs().sum(dim=-1).to(q_rows.device)
    return dist


def count_off(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of ``a`` that differ from ``b`` (every entry when shapes differ)."""
    if tuple(a.shape) != tuple(b.shape):
        return max(a.numel(), b.numel(), 1)
    return int((a.to(b.device, torch.int64) != b.to(torch.int64)).sum())


def cell_tables_off(prog, ref: dslsh.Cell) -> int:
    """Entries of one program cell (the port's ``SLSHIndex``, whose outer
    tables may be padded past its ``n`` rows) that differ from the
    reference's cell."""
    n = ref.n
    if int(prog.n) != n:
        return max(ref.sorted_keys.numel(), 1)
    hv = prog.heavy
    pairs = [
        (prog.outer.sorted_keys[:, :n], ref.sorted_keys), (prog.outer.sorted_idx[:, :n], ref.sorted_idx),
        (hv.keys, ref.heavy_keys), (hv.start, ref.heavy_start), (hv.size, ref.heavy_size),
        (hv.valid, ref.heavy_valid), (hv.overflowed, ref.heavy_overflowed),
        (prog.inner_keys, ref.inner_keys), (prog.inner_idx, ref.inner_idx),
    ]
    return sum(count_off(a, b) for a, b in pairs)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and ``{name: {value, limit}}`` for every limited number; a
    number the run did not produce fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    return ok, out
