"""Exhaustive K-NN, the paper's PKNN baseline (``repro.core.pknn``).

The search is chunked over queries and over data rows with a running
top-k, so no (Q, n) distance matrix exists: at the paper's 1.37 M points a
chunk holds ``chunk * data_chunk`` distances. Ties go to the lowest data
index, as ``lax.top_k`` gives them.
"""
from __future__ import annotations

import torch

from repro_torch.core import topk


def knn_exhaustive(
    data: torch.Tensor, q: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact l1 K-NN of one query (d,) over ``data``; (k,) dists & idx."""
    kd, ki = knn_batch(data, q[None, :], k)
    return kd[0], ki[0]


def knn_batch(
    data: torch.Tensor, queries: torch.Tensor, k: int,
    chunk: int = 64, data_chunk: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked exact l1 K-NN: (Q, d) queries -> (Q, k) dists & int32 indices."""
    n = data.shape[0]
    out_d, out_i = [], []
    for lo in range(0, queries.shape[0], chunk):
        qs = queries[lo : lo + chunk]
        best_d = torch.full((qs.shape[0], 0), topk.INF, device=data.device)
        best_i = torch.full((qs.shape[0], 0), -1, dtype=torch.int32, device=data.device)
        for d0 in range(0, n, data_chunk):
            rows = data[d0 : d0 + data_chunk]
            dist = (rows[None, :, :] - qs[:, None, :]).abs().sum(dim=-1)
            idx = torch.arange(d0, d0 + rows.shape[0], dtype=torch.int32, device=data.device)
            # running best first: it holds lower indices, so ties keep them
            best_d, best_i = topk.masked_topk_smallest(
                torch.cat([best_d, dist], -1),
                torch.cat([best_i, idx.expand(dist.shape)], -1), k,
            )
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)
