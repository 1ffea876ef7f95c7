"""Static-shape LSH hash tables in CSR form (counterpart of ``repro.core.tables``).

Per table the point indices are kept sorted by bucket key; a bucket is the
contiguous ``[lo, hi)`` slice two binary searches find. Keys are int64
holding 32-bit values (see ``core/hashing.py``); indices stay int32 in
stored state, as in the JAX package, and widen to int64 only where they
index.

The sorts are ``torch.sort(stable=True)``, so tied keys order by point index
exactly as the JAX package's ``lax.sort`` orders them.

Divergences from the JAX package's Pallas backend (neither changes a
result on the test or smoke data):

* The port's sign-projection bit is ``>= 0`` (the family's definition), in
  the kernel as in the plain version; the Pallas kernel uses ``> 0``. They
  differ only at an exact zero projection.
* ``pipeline.build_inner`` hashes every heavy-bucket point through the
  selected backend (on the card: the ``proj_sign_pack`` kernel that also
  hashes queries), where the JAX package hashes them with the plain
  ``hash_points``. Build and query therefore hash a point with one
  implementation; the plain and kernel sums differ only in rounding, which
  cannot flip a bit whose projection is not within rounding of zero.

Preconditions kept from the reference: a table needs ``n >= 1`` points and
``n >= h_max`` (``lax.top_k`` over the n segments needs ``k <= n``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

PAD_KEY = 0xFFFFFFFF
_INT32_MAX = 2**31 - 1


class TableSet(NamedTuple):
    sorted_keys: torch.Tensor  # (L, n) int64, each row ascending
    sorted_idx: torch.Tensor  # (L, n) int32, dataset indices aligned with keys


class HeavyBuckets(NamedTuple):
    """Top-H_max buckets per table with population > alpha*n (paper §2)."""

    keys: torch.Tensor  # (L, H) int64 bucket key (PAD_KEY where invalid)
    start: torch.Tensor  # (L, H) int32 offset into the table's sorted arrays
    size: torch.Tensor  # (L, H) int32 true population
    valid: torch.Tensor  # (L, H) bool
    overflowed: torch.Tensor  # (L,) int32 heavy buckets beyond the H budget


def sort_rows(keys: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of each row of ``keys`` carrying ``idx`` along."""
    sk, order = torch.sort(keys, dim=-1, stable=True)
    return sk, torch.gather(idx, -1, order)


def build_tables(keys: torch.Tensor) -> TableSet:
    """keys: (L, n) int64 -> sorted tables."""
    sk, order = torch.sort(keys, dim=-1, stable=True)
    return TableSet(sk, order.to(torch.int32))


def find_heavy(tables: TableSet, alpha_n: int, h_max: int) -> HeavyBuckets:
    """Top-``h_max`` buckets per table with population > ``alpha_n``.

    Ties in population go to the bucket that starts first (``lax.top_k``'s
    lowest-index rule). The PAD segment is never classified heavy.
    """
    sk = tables.sorted_keys
    n_tab, n = sk.shape
    if n < 1 or n < h_max:
        raise ValueError(
            f"find_heavy needs n >= 1 and n >= h_max points per table; got"
            f" n={n}, h_max={h_max}"
        )
    dev = sk.device
    pos = torch.arange(n, dtype=torch.int64, device=dev).expand(n_tab, n)
    is_start = torch.ones_like(sk, dtype=torch.bool)
    is_start[:, 1:] = sk[:, 1:] != sk[:, :-1]
    seg_id = torch.cumsum(is_start.to(torch.int64), dim=1) - 1  # (L, n)
    sizes = torch.zeros((n_tab, n), dtype=torch.int64, device=dev).scatter_add_(
        1, seg_id, torch.ones_like(seg_id)
    )
    starts = torch.full((n_tab, n), _INT32_MAX, dtype=torch.int64, device=dev)
    starts = starts.scatter_reduce(
        1, seg_id, torch.where(is_start, pos, n), reduce="amin", include_self=True
    )
    seg_key = torch.gather(sk, 1, starts.clamp(0, n - 1))
    heavy_sizes = torch.where((sizes > alpha_n) & (seg_key != PAD_KEY), sizes, 0)
    top_sizes, top_segs = torch.sort(heavy_sizes, dim=1, descending=True, stable=True)
    top_sizes, top_segs = top_sizes[:, :h_max], top_segs[:, :h_max]
    valid = top_sizes > 0
    top_start = torch.where(valid, torch.gather(starts, 1, top_segs), 0)
    top_key = torch.where(valid, torch.gather(sk, 1, top_start), PAD_KEY)
    overflow = (heavy_sizes > 0).sum(dim=1) - valid.sum(dim=1)
    return HeavyBuckets(
        top_key,
        top_start.to(torch.int32),
        top_sizes.to(torch.int32),
        valid,
        overflow.to(torch.int32),
    )


def find_heavy_streamed(tables: TableSet, alpha_n: int, h_max: int) -> HeavyBuckets:
    """:func:`find_heavy` one table at a time: (n,)-sized transients instead
    of (L, n)-sized ones, for the memory-bounded chunked build."""
    parts = [
        find_heavy(TableSet(k[None], i[None]), alpha_n, h_max)
        for k, i in zip(tables.sorted_keys, tables.sorted_idx)
    ]
    return HeavyBuckets(*(torch.cat(f, dim=0) for f in zip(*parts)))


def bucket_range(
    sorted_keys_row: torch.Tensor, key: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """[lo, hi) slice of one table's sorted arrays holding ``key``."""
    lo = torch.searchsorted(sorted_keys_row, key, side="left")
    hi = torch.searchsorted(sorted_keys_row, key, side="right")
    return lo.to(torch.int32), hi.to(torch.int32)


def gather_bucket(
    sorted_idx_row: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, budget: int
) -> torch.Tensor:
    """Up to ``budget`` dataset indices from [lo, hi); -1 where masked."""
    offs = lo.long()[..., None] + torch.arange(budget, device=lo.device)
    ok = offs < hi.long()[..., None]
    idx = sorted_idx_row[offs.clamp(0, sorted_idx_row.shape[0] - 1)]
    return torch.where(ok, idx, -1)
