"""Incremental DSLSH: a base CSR index plus an append-only delta segment.

Counterpart of ``repro.stream.index``. ``StreamIndex`` is the online form
of ``pipeline.SLSHIndex`` (DESIGN.md §9):

* ``insert_batch`` — hash the batch with the configured backend (kernels
  A and B on the card) and write its keys into the delta segment and its
  rows into the point store. New points are queryable immediately.
* ``query_batch`` — the pipeline with the gather fanned out over base +
  delta (``pipeline.query_batch(..., delta=...)``).
* ``compact`` — fold the delta into the base: a per-table stable merge of
  the CSR rows (base points are never re-hashed or re-sorted), then a
  refresh of the heavy registry and the inner layer. Bit-exact with a
  from-scratch build over the union.
* ``evict_before`` — retention: drop windows older than a horizon and
  rebuild the smaller base.

Querying a ``StreamIndex`` equals querying a from-scratch
``build_from_params`` over base ∪ delta whenever the base's heavy
registry agrees with the union's (always after ``compact``).

The base's ``n`` and the delta's ``count`` are host ints. Every write is
out-of-place, so a ``StreamIndex`` that shares tensors with another never
sees the other's later inserts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import merge, pipeline, tables
from repro_torch.stream import delta as delta_mod


class StreamIndex(NamedTuple):
    base: pipeline.SLSHIndex
    delta: delta_mod.DeltaIndex
    store: torch.Tensor  # (capacity, d) f32 — rows [0, n_total) hold points
    ts: torch.Tensor  # (capacity,) f32 arrival time per stored point

    @property
    def n_total(self) -> int:
        """Points queryable right now (base + delta)."""
        return self.base.n + self.delta.count

    @property
    def capacity(self) -> int:
        """Fixed store size; CSR rows stay padded to it (DESIGN.md §9.1)."""
        return self.store.shape[0]


def pad_tables(outer: tables.TableSet, capacity: int) -> tables.TableSet:
    """Right-pad CSR rows to ``capacity`` with inert entries: ``PAD_KEY``
    sorts after every real key and its index is -1."""
    l, n = outer.sorted_keys.shape
    if n > capacity:
        raise ValueError(f"index of {n} rows larger than store capacity {capacity}")
    if n == capacity:
        return outer
    dev = outer.sorted_keys.device
    return tables.TableSet(
        torch.cat([outer.sorted_keys, torch.full((l, capacity - n), tables.PAD_KEY, dtype=torch.int64, device=dev)], 1),
        torch.cat([outer.sorted_idx, torch.full((l, capacity - n), -1, dtype=torch.int32, device=dev)], 1),
    )


def _store(data: torch.Tensor, capacity: int, ts_rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A zeroed ``capacity``-row store and timestamp vector holding
    ``data`` and ``ts_rows`` in their first rows."""
    n0, d = data.shape
    store = torch.zeros((capacity, d), dtype=torch.float32, device=data.device)
    store[:n0] = data
    ts = torch.zeros((capacity,), dtype=torch.float32, device=data.device)
    ts[:n0] = ts_rows
    return store, ts


def from_base(
    base: pipeline.SLSHIndex,
    data: torch.Tensor,
    cfg: pipeline.SLSHConfig,
    *,
    capacity: int,
    delta_cap: int,
    t0: float = 0.0,
) -> StreamIndex:
    """Wrap a prebuilt (possibly row-sliced, per-cell) index for streaming."""
    n0 = data.shape[0]
    if capacity < n0:
        raise ValueError(f"store capacity {capacity} below the initial {n0} points")
    l_out = base.outer_params.salts.shape[0]
    base = base._replace(outer=pad_tables(base.outer, capacity))
    store, ts = _store(data, capacity, torch.tensor(t0, dtype=torch.float32))
    return StreamIndex(base, delta_mod.make_delta(delta_cap, l_out, cfg.L_in, data.device), store, ts)


def stream_init(
    key,
    data: torch.Tensor,
    cfg: pipeline.SLSHConfig,
    *,
    capacity: int,
    delta_cap: int,
    t0: float = 0.0,
) -> StreamIndex:
    """Build a fresh single-shard streaming index over ``data`` (n0, d) on
    its device. ``key`` is a seed, a ``torch.Generator`` or an ``(outer,
    inner)`` family (``pipeline.family_from_key``).

    >>> import torch
    >>> cfg = pipeline.SLSHConfig.compose(m_out=8, L_out=4, m_in=4, L_in=2,
    ...     alpha=0.05, k=3, val_lo=0.0, val_hi=1.0, c_max=16, c_in=8,
    ...     h_max=2, p_max=32, use_inner=False, backend="torch")
    >>> data = torch.rand((32, 8), generator=torch.Generator().manual_seed(0))
    >>> sidx = stream_init(1, data, cfg, capacity=48, delta_cap=16)
    >>> extra = torch.rand((8, 8), generator=torch.Generator().manual_seed(2))
    >>> sidx = insert_batch(sidx, extra, cfg, t=1.0)
    >>> sidx.n_total  # streamed points are queryable immediately
    40
    >>> query_batch(sidx, extra[:2], cfg).knn_idx[:, 0].tolist()  # ...and find themselves
    [32, 33]
    >>> compact(sidx, cfg).delta.count  # compaction empties the delta
    0
    """
    outer, inner = pipeline.family_from_key(key, data.shape[1], cfg, data.device)
    base = pipeline.build_from_params(data, outer, inner, cfg)
    return from_base(base, data, cfg, capacity=capacity, delta_cap=delta_cap, t0=t0)


def delta_room(capacity: int, delta_cap: int, n: int) -> int:
    """Usable delta slots: bounded by the segment and by the store left —
    the one formula every insert path derives its drops from."""
    return min(delta_cap, capacity - n)


def hash_for_insert(
    index: pipeline.SLSHIndex, xs: torch.Tensor, cfg: pipeline.SLSHConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Backend-dispatched outer + inner keys ``(B, L)``, ``(B, L_in)`` for
    one insert batch: the ``pipeline.hash_keys`` of build and query, so a
    streamed point lands in the buckets a rebuild would put it in."""
    backend = pipeline.get_backend(cfg.backend, cfg)
    outer_keys = pipeline.hash_keys(index.outer_params, xs, backend)
    if cfg.use_inner:
        inner_keys = pipeline.hash_keys(index.inner_params, xs, backend)
    else:
        inner_keys = torch.zeros((xs.shape[0], cfg.L_in), dtype=torch.int64, device=xs.device)
    return outer_keys, inner_keys


def scatter_rows(
    store: torch.Tensor,
    ts: torch.Tensor,
    n: int,
    count: int,
    room: int,
    xs: torch.Tensor,
    t: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one batch's points and timestamps into store rows
    ``[n + count, n + min(count + B, room))`` (new tensors); the rest of
    the batch drops, as ``delta.append_keys`` counts it."""
    fit = max(0, min(xs.shape[0], room - count))
    rows = torch.arange(n + count, n + count + fit, device=store.device)
    store = store.index_copy(0, rows, xs[:fit].to(torch.float32))
    ts = ts.index_copy(0, rows, torch.full((fit,), t, dtype=torch.float32, device=ts.device))
    return store, ts


def insert_batch(
    sidx: StreamIndex, xs: torch.Tensor, cfg: pipeline.SLSHConfig, t: float = 0.0
) -> StreamIndex:
    """Ingest one batch: hash -> write keys and rows. Inserts beyond the
    delta capacity (or the store's) drop and count in ``delta.dropped``;
    callers should ``compact`` first."""
    xs = torch.as_tensor(xs, dtype=torch.float32, device=sidx.store.device)
    outer_keys, inner_keys = hash_for_insert(sidx.base, xs, cfg)
    room = delta_room(sidx.capacity, sidx.delta.outer_keys.shape[0], sidx.base.n)
    new_delta = delta_mod.append_keys(sidx.delta, outer_keys, inner_keys, room)
    store, ts = scatter_rows(sidx.store, sidx.ts, sidx.base.n, sidx.delta.count, room, xs, t)
    return StreamIndex(sidx.base, new_delta, store, ts)


def query_batch(
    sidx: StreamIndex, queries: torch.Tensor, cfg: pipeline.SLSHConfig
) -> pipeline.QueryResult:
    """The pipeline over base + delta; backend dispatch included."""
    queries = torch.as_tensor(queries, dtype=torch.float32, device=sidx.store.device)
    view = delta_mod.as_view(sidx.delta, sidx.base.n)
    return pipeline.query_batch(sidx.base, sidx.store, queries, cfg, delta=view)


# ------------------------------------------------------------- compaction


def compact(sidx: StreamIndex, cfg: pipeline.SLSHConfig) -> StreamIndex:
    """Fold the delta segment into the base index.

    The outer CSR rows are merged, not rebuilt: the delta's keys are
    stably sorted into one run per table and merged after the base's real
    rows (the base wins ties, ``core.merge``); only the heavy registry and
    the inner layer are recomputed. Bit-exact with
    ``pipeline.build_from_params`` over base ∪ delta.
    """
    base = sidx.base
    n0, cnt = base.n, sidx.delta.count
    if cnt == 0:
        return sidx
    n1 = n0 + cnt
    l_out = base.outer_params.salts.shape[0]
    dev = sidx.store.device
    d_keys = sidx.delta.outer_keys[:cnt].T.contiguous()  # (L, cnt), slot order = gidx order
    d_gidx = torch.arange(n0, n1, dtype=torch.int32, device=dev).expand(l_out, cnt)
    dk, di = tables.sort_rows(d_keys, d_gidx)
    # merge against the base's real prefix only, so even a real key that
    # aliases PAD_KEY merges correctly; then re-pad to capacity
    mk, mi = merge.merge_sorted_rows(
        base.outer.sorted_keys[:, :n0].contiguous(), base.outer.sorted_idx[:, :n0].contiguous(), dk, di
    )
    outer = pad_tables(tables.TableSet(mk, mi), sidx.capacity)
    heavy = tables.find_heavy(outer, max(int(cfg.alpha * n1), 1), cfg.h_max)
    if cfg.use_inner:
        inner_keys, inner_idx = pipeline.build_inner(
            base.inner_params, sidx.store[:n1], outer, heavy, cfg,
            pipeline.get_backend(cfg.backend, cfg),
        )
    else:
        inner_keys, inner_idx = pipeline.empty_inner(l_out, cfg, dev)
    new_base = pipeline.SLSHIndex(
        base.outer_params, base.inner_params, outer, heavy, inner_keys, inner_idx, n1
    )
    cap = sidx.delta.outer_keys.shape[0]
    return StreamIndex(new_base, delta_mod.make_delta(cap, l_out, cfg.L_in, dev), sidx.store, sidx.ts)


def retention_keep(ts: torch.Tensor, n: int, t_min: float, h_max: int) -> torch.Tensor:
    """Surviving (ascending) store rows under a retention horizon; never
    fewer than ``min(h_max, n)``, the newest (slots fill in arrival order)."""
    keep = torch.nonzero(ts[:n] >= t_min).flatten().to(torch.int64)
    min_keep = min(max(h_max, 1), n)
    if keep.shape[0] < min_keep:
        keep = torch.arange(n - min_keep, n, device=ts.device)
    return keep


def evict_before(
    sidx: StreamIndex, cfg: pipeline.SLSHConfig, t_min: float
) -> tuple[StreamIndex, torch.Tensor]:
    """Drop stored points with ``ts < t_min`` and rebuild the base (it
    compacts first). Returns the new index and the kept old global indices
    (ascending): old ``keep[i]`` becomes new ``i``."""
    sidx = compact(sidx, cfg)
    n = sidx.base.n
    keep = retention_keep(sidx.ts, n, t_min, cfg.h_max)
    if keep.shape[0] == n:
        return sidx, keep
    data = sidx.store[keep]
    base = pipeline.build_from_params(data, sidx.base.outer_params, sidx.base.inner_params, cfg)
    base = base._replace(outer=pad_tables(base.outer, sidx.capacity))
    store, ts = _store(data, sidx.capacity, sidx.ts[keep])
    cap = sidx.delta.outer_keys.shape[0]
    l_out = sidx.base.outer_params.salts.shape[0]
    return StreamIndex(base, delta_mod.make_delta(cap, l_out, cfg.L_in, store.device), store, ts), keep
