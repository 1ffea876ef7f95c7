"""Stratified LSH, one cell at a time, in plain PyTorch (paper §2-§3).

What a cell holds, from its rows ``x`` (n, d) and its slice of the family:

* Outer keys: bit ``j`` of table ``l`` is ``x[dims[l, j]] > thrs[l, j]``;
  a table's ``m`` bits pack little-endian into 32-bit words, and the key
  is FNV-1a over the words' bytes (low byte first), started from
  ``salt ^ 2166136261`` and kept to 32 bits after each multiply by
  16777619. Each table's keys sort stably, so a bucket lists its rows in
  ascending order.
* Heavy buckets: per table the ``h_max`` largest buckets holding more than
  ``max(int(alpha * n), 1)`` rows (ties to the bucket that starts first;
  the padding key 0xFFFFFFFF is never heavy). A bucket's first ``p_max``
  rows are hashed into ``L_in`` sign-projection tables, each sorted
  stably, padded with key 0xFFFFFFFF and row -1.
* Inner keys: bit ``j`` of inner table ``t`` is ``s >= 0`` with ``s = x .
  proj[t, :, j]`` in float32, summed as one ``fmaf`` chain from 0 over
  the coordinates in ascending order (products exact in float64, each
  step rounded once to float32). The order matters: a sign taken from
  another summation flips where ``|s|`` is within rounding of 0, and one
  flipped bit moves a row to another bucket.

A query looks up each table: where its key names a heavy bucket, the
first ``c_in`` rows of each inner bucket its inner keys name, else the
first ``c_max`` rows of the outer bucket. The union's distinct rows are
the paper's comparisons; the first ``c_comp`` of them (ascending) are
compared by L1 distance, computed in float64, and the ``k`` nearest kept
(ties to the lower row).

A streaming cell adds a delta segment: rows appended after the base,
whose keys join the base windows (the union's first ``c_max`` or ``c_in``
rows, base rows first) while the heavy registry and inner tables stay
the base's; a delta row joins a heavy bucket's inner population while the
bucket's size plus the row's rank among the bucket's delta rows stays
under ``p_max``. A compaction makes every row base.
"""
from __future__ import annotations

import dataclasses

import torch

FNV_PRIME = 16777619
FNV_BASIS = 2166136261
MASK32 = 0xFFFFFFFF
PAD_KEY = 0xFFFFFFFF
_BIG = 2**62  # sorts after every row


def fnv_keys(bits: torch.Tensor, salts: torch.Tensor) -> torch.Tensor:
    """Bits (n, L, m) -> bucket keys (n, L) int64 in [0, 2**32)."""
    n, n_tab, m = bits.shape
    n_words = -(-m // 32)
    if n_words * 32 > m:
        bits = torch.cat([bits, bits.new_zeros((n, n_tab, n_words * 32 - m))], dim=-1)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(32, device=bits.device)
    words = (bits.reshape(n, n_tab, n_words, 32).to(torch.int64) * weights).sum(-1)
    h = (salts.to(torch.int64) ^ FNV_BASIS).expand(n, n_tab)
    for w in range(n_words):
        for shift in (0, 8, 16, 24):
            h = ((h ^ ((words[..., w] >> shift) & 0xFF)) * FNV_PRIME) & MASK32
    return h


def outer_keys(x: torch.Tensor, dims: torch.Tensor, thrs: torch.Tensor, salts: torch.Tensor) -> torch.Tensor:
    """x (n, d) -> (n, L) bit-sampling keys."""
    return fnv_keys(x[:, dims.long()] > thrs[None], salts)


def projections(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """x (n, d) float32, proj (L, d, m) float32 -> s (n, L, m) float32 as a
    sequential fmaf chain over d."""
    xd, pd = x.to(torch.float64), proj.to(torch.float64)
    s = torch.zeros((x.shape[0],) + (proj.shape[0], proj.shape[2]), dtype=torch.float32, device=x.device)
    for j in range(x.shape[1]):
        s = (s.to(torch.float64) + xd[:, j, None, None] * pd[None, :, j, :]).to(torch.float32)
    return s


def inner_keys(x: torch.Tensor, proj: torch.Tensor, salts: torch.Tensor) -> torch.Tensor:
    """x (n, d) -> (n, L_in) sign-projection keys."""
    return fnv_keys(projections(x, proj) >= 0.0, salts)


@dataclasses.dataclass
class Cell:
    """One cell's tables (the names of the port's ``SLSHIndex`` leaves)."""

    sorted_keys: torch.Tensor  # (L, n) int64
    sorted_idx: torch.Tensor  # (L, n) int64 rows
    heavy_keys: torch.Tensor  # (L, H) int64, PAD_KEY where not valid
    heavy_start: torch.Tensor  # (L, H) int64, 0 where not valid
    heavy_size: torch.Tensor  # (L, H) int64, 0 where not valid
    heavy_valid: torch.Tensor  # (L, H) bool
    heavy_overflowed: torch.Tensor  # (L,) int64 heavy buckets past h_max
    inner_keys: torch.Tensor  # (L, H, L_in, P) int64
    inner_idx: torch.Tensor  # (L, H, L_in, P) int64, -1 pad
    n: int


def build_cell(x: torch.Tensor, outer: dict, inner: dict, cfg: dict) -> Cell:
    """A cell over rows ``x`` (n, d) with ``outer`` this cell's tables of the
    bit-sampling family and ``inner`` the whole inner family."""
    n = x.shape[0]
    dev = x.device
    h_max, p_max = cfg["h_max"], cfg["p_max"]
    keys, idx = torch.sort(outer_keys(x, outer["dims"], outer["thrs"], outer["salts"]).T.contiguous(), dim=1, stable=True)
    n_tab = keys.shape[0]
    alpha_n = max(int(cfg["alpha"] * n), 1)
    hk = torch.full((n_tab, h_max), PAD_KEY, dtype=torch.int64, device=dev)
    hs = torch.zeros((n_tab, h_max), dtype=torch.int64, device=dev)
    hz = torch.zeros((n_tab, h_max), dtype=torch.int64, device=dev)
    hv = torch.zeros((n_tab, h_max), dtype=torch.bool, device=dev)
    over = torch.zeros((n_tab,), dtype=torch.int64, device=dev)
    for t in range(n_tab):
        uk, counts = torch.unique_consecutive(keys[t], return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        heavy = (counts > alpha_n) & (uk != PAD_KEY)
        size, start, key = counts[heavy], starts[heavy], uk[heavy]
        order = torch.sort(-size, stable=True).indices  # starts ascend already
        take = order[:h_max]
        m = take.shape[0]
        hk[t, :m], hs[t, :m], hz[t, :m], hv[t, :m] = key[take], start[take], size[take], True
        over[t] = size.shape[0] - m
    ar = torch.arange(p_max, device=dev)
    in_pop = (ar < hz[..., None]) & hv[..., None]  # (L, H, P)
    offs = (hs[..., None] + ar).clamp(max=n - 1)
    rows = torch.where(in_pop, torch.gather(idx, 1, offs.reshape(n_tab, -1)).reshape(offs.shape), -1)
    ik = inner_keys(x[rows.clamp(min=0).reshape(-1)], inner["proj"], inner["salts"])
    ik = ik.reshape(n_tab, h_max, p_max, -1).permute(0, 1, 3, 2)  # (L, H, L_in, P)
    ik = torch.where(in_pop[:, :, None, :], ik, PAD_KEY)
    ik, order = torch.sort(ik, dim=-1, stable=True)
    ii = torch.gather(rows[:, :, None, :].expand(ik.shape), -1, order)
    return Cell(keys, idx, hk, hs, hz, hv, over, ik.contiguous(), ii.contiguous(), n)


def compact_width(cfg: dict, c_total: int, n_data: int) -> int:
    """The compacted buffer of a query: ``c_comp`` (all when <= 0) cut to the
    gathered width and to ``n_data`` rounded up to 128."""
    cc = c_total if cfg["c_comp"] <= 0 else min(cfg["c_comp"], c_total)
    return max(1, min(cc, -(-n_data // 128) * 128))


def _first(vals: torch.Tensor, width: int) -> torch.Tensor:
    """The ``width`` smallest of each row (``_BIG`` pads), -1 for padding."""
    out = torch.sort(vals, dim=-1).values[..., :width]
    return torch.where(out == _BIG, -1, out)


def candidates(cell: Cell, qk: torch.Tensor, qi: torch.Tensor, cfg: dict, delta: dict | None = None) -> torch.Tensor:
    """The rows each query gathers: (Q, L * width), -1 padded.

    ``qk`` (Q, L) are the queries' keys for this cell's tables and ``qi``
    (Q, L_in) their inner keys; ``delta`` holds ``outer`` (cnt, L) and
    ``inner`` (cnt, L_in) keys of rows ``base_n ..``."""
    c_max, c_in, p_max = cfg["c_max"], cfg["c_in"], cfg["p_max"]
    n_q, n_tab = qk.shape
    l_in = qi.shape[1]
    width = max(c_max, l_in * c_in)
    dev = qk.device
    n = cell.n
    if delta is not None:
        cnt = delta["outer"].shape[0]
        dids = cell.n + torch.arange(cnt, device=dev)
    parts = []
    for t in range(n_tab):
        key = qk[:, t].contiguous()
        lo = torch.searchsorted(cell.sorted_keys[t], key, side="left")
        hi = torch.searchsorted(cell.sorted_keys[t], key, side="right")
        pos = lo[:, None] + torch.arange(c_max, device=dev)
        win = torch.where(pos < hi[:, None], cell.sorted_idx[t][pos.clamp(max=n - 1)], _BIG)
        if delta is not None:
            dm = delta["outer"][None, :, t] == key[:, None]  # (Q, cnt)
            win = torch.cat([win, torch.where(dm, dids, _BIG)], dim=1)
        outer = _first(win, c_max)
        hm = (cell.heavy_keys[t][None, :] == key[:, None]) & cell.heavy_valid[t][None, :]
        found = hm.any(dim=1)
        h = hm.to(torch.int32).argmax(dim=1)
        ik, ii = cell.inner_keys[t][h], cell.inner_idx[t][h]  # (Q, L_in, P)
        lo2 = torch.searchsorted(ik, qi[:, :, None], side="left")[..., 0]
        hi2 = torch.searchsorted(ik, qi[:, :, None], side="right")[..., 0]
        pos2 = lo2[..., None] + torch.arange(c_in, device=dev)
        iw = torch.where(pos2 < hi2[..., None], torch.gather(ii, 2, pos2.clamp(max=p_max - 1)), _BIG)
        if delta is not None:
            rank = torch.cumsum(dm.to(torch.int64), dim=1) - 1
            pop = dm & (cell.heavy_size[t][h][:, None] + rank < p_max)
            dmi = pop[:, None, :] & (delta["inner"].T[None] == qi[:, :, None])  # (Q, L_in, cnt)
            iw = torch.cat([iw, torch.where(dmi, dids, _BIG)], dim=2)
        inner = _first(iw, c_in).reshape(n_q, l_in * c_in)
        pad = lambda a: torch.nn.functional.pad(a, (0, width - a.shape[1]), value=-1)  # noqa: E731
        parts.append(torch.where(found[:, None], pad(inner), pad(outer)))
    return torch.cat(parts, dim=1)


@dataclasses.dataclass
class Answer:
    """A cell's (or a merged) answer to a query batch."""

    dist: torch.Tensor  # (Q, k) float64, inf pad
    idx: torch.Tensor  # (Q, k) int64 rows, -1 pad
    comparisons: torch.Tensor | None = None  # (Q,) distinct candidates


def query_cell(cell: Cell, rows: torch.Tensor, q: torch.Tensor, qk: torch.Tensor, qi: torch.Tensor,
               cfg: dict, n_data: int, delta: dict | None = None, block: int = 256) -> Answer:
    """One cell's answer over its rows ``rows`` (base, then delta rows);
    ``n_data`` is the row count the program's data tensor has (it sets the
    compacted width)."""
    outs = []
    for lo in range(0, q.shape[0], block):
        sl = slice(lo, lo + block)
        cand = torch.sort(candidates(cell, qk[sl], qi[sl], cfg, delta), dim=1).values
        uniq = cand >= 0
        uniq[:, 1:] &= cand[:, 1:] != cand[:, :-1]
        comps = uniq.sum(dim=1)
        cc = compact_width(cfg, cand.shape[1], n_data)
        comp = torch.sort(torch.where(uniq, cand, _BIG), dim=1).values[:, :cc]
        ok = comp != _BIG
        pts = rows[comp.clamp(max=rows.shape[0] - 1).masked_fill(~ok, 0)].to(torch.float64)
        dist = (pts - q[sl, None, :].to(torch.float64)).abs().sum(dim=-1)
        dist = torch.where(ok, dist, torch.inf)
        order = torch.sort(dist, dim=1, stable=True).indices[:, : cfg["k"]]
        kd = torch.gather(dist, 1, order)
        ki = torch.where(torch.isfinite(kd), torch.gather(comp, 1, order), -1)
        if kd.shape[1] < cfg["k"]:
            kd = torch.nn.functional.pad(kd, (0, cfg["k"] - kd.shape[1]), value=torch.inf)
            ki = torch.nn.functional.pad(ki, (0, cfg["k"] - ki.shape[1]), value=-1)
        outs.append(Answer(kd, ki, comps))
    return Answer(*(torch.cat([getattr(a, f) for a in outs]) for f in ("dist", "idx", "comparisons")))


def merge(answers: list[Answer], k: int, unique: bool = False) -> Answer:
    """The k nearest over partial answers taken in list order (ties to the
    earlier partial); ``unique`` first keeps one entry per row (cells of a
    streaming node share its rows)."""
    dist = torch.cat([a.dist for a in answers], dim=1)
    idx = torch.cat([a.idx for a in answers], dim=1)
    if unique:
        order = torch.sort(idx, dim=1, stable=True).indices
        idx, dist = torch.gather(idx, 1, order), torch.gather(dist, 1, order)
        dup = torch.zeros_like(idx, dtype=torch.bool)
        dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
        dist = torch.where(dup | (idx < 0), torch.inf, dist)
    order = torch.sort(dist, dim=1, stable=True).indices[:, :k]
    kd = torch.gather(dist, 1, order)
    return Answer(kd, torch.where(torch.isfinite(kd), torch.gather(idx, 1, order), -1))


def vote(labels: torch.Tensor, idx: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """The AHE vote: neighbours weighted by 1 / (distance + 1e-6), AHE where
    the weighted share of AHE neighbours is at least one half."""
    ok = idx >= 0
    w = torch.where(ok, 1.0 / (dist.to(torch.float64) + 1e-6), 0.0)
    y = labels[idx.clamp(min=0)].to(torch.float64)
    return ((w * y).sum(dim=1) / w.sum(dim=1).clamp(min=1e-9) >= 0.5).to(torch.int64)


def cell_tables(outer: dict, c: int, l_loc: int) -> dict:
    """Core ``c``'s slice of the bit-sampling family."""
    return {k: v[c * l_loc : (c + 1) * l_loc] for k, v in outer.items()}
