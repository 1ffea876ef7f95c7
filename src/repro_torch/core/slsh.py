"""Stratified LSH index (paper §2), single shard: the façade over
``core/pipeline.py`` (counterpart of ``repro.core.slsh``).

Static-shape budgets: ``c_max`` candidates per outer probe, ``c_in`` per
inner probe, ``h_max`` heavy buckets per outer table, ``p_max`` inner
population cap per heavy bucket.
"""
from __future__ import annotations

import torch

from repro_torch.core import pipeline
from repro_torch.core.pipeline import (  # noqa: F401  (re-exported public API)
    BudgetConfig,
    ConfigError,
    FamilyConfig,
    QueryResult,
    RuntimeConfig,
    SLSHConfig,
    SLSHIndex,
)


def build_index(gen: torch.Generator, data: torch.Tensor, cfg: SLSHConfig) -> SLSHIndex:
    """Build a stratified LSH index over ``data`` (n, d), drawing the hash
    family from ``gen`` onto ``data``'s device.

    >>> import torch
    >>> cfg = SLSHConfig.compose(m_out=8, L_out=4, m_in=4, L_in=2, alpha=0.05,
    ...                          k=3, val_lo=0.0, val_hi=1.0, c_max=16, c_in=8,
    ...                          h_max=2, p_max=32, backend="torch")
    >>> data = torch.rand((64, 8), generator=torch.Generator().manual_seed(0))
    >>> index = build_index(torch.Generator().manual_seed(1), data, cfg)
    >>> res = query_batch(index, data, data[:4], cfg)
    >>> res.knn_idx[:, 0].tolist()  # each point finds itself first
    [0, 1, 2, 3]
    """
    outer, inner = pipeline.make_family(gen, data.shape[1], cfg, data.device)
    return pipeline.build_from_params(data, outer, inner, cfg)


def query_index(
    index: SLSHIndex, data: torch.Tensor, q: torch.Tensor, cfg: SLSHConfig
) -> QueryResult:
    """Resolve one query (d,) against a single-shard index."""
    res = pipeline.query_batch(index, data, q[None, :], cfg)
    return QueryResult(*(a[0] for a in res))


def query_batch(
    index: SLSHIndex, data: torch.Tensor, queries: torch.Tensor, cfg: SLSHConfig
) -> QueryResult:
    """Chunked pipeline over queries -> stacked QueryResult (Q, ...)."""
    return pipeline.query_batch(index, data, queries, cfg)
