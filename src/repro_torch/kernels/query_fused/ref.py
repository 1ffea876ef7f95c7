"""Plain PyTorch version of the fused query tail (``csrc/query_fused.cu``).

Pipeline stages 3-5 in their staged form — full-width sort dedup, sentinel
sort-compact, masked L1 top-k — over the same (Q, C) candidate tensor the
kernel consumes. Unlike the kernel, rows need no run structure here.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import masked_l1_topk_batch

SENT = 2**31 - 1  # sorts after any real index


def query_tail_ref(
    data: torch.Tensor,  # (n, d)
    queries: torch.Tensor,  # (Q, d)
    cand: torch.Tensor,  # (Q, C) int32, -1 where masked
    *,
    c_comp: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> ``(kd (Q, k), ki (Q, k) int32, comparisons (Q,), overflow (Q,))``."""
    n = data.shape[0]
    cand_sorted = torch.sort(cand, dim=-1).values
    uniq = torch.ones_like(cand_sorted, dtype=torch.bool)
    uniq[:, 1:] = cand_sorted[:, 1:] != cand_sorted[:, :-1]
    uniq &= cand_sorted >= 0
    comparisons = uniq.sum(dim=-1, dtype=torch.int32)
    comp = torch.sort(torch.where(uniq, cand_sorted, SENT), dim=-1).values[:, :c_comp]
    valid = comp != SENT
    overflow = (comparisons - c_comp).clamp(min=0)
    comp = torch.where(valid, comp, -1)
    pts = data[comp.long().clamp(0, n - 1)]  # (Q, c_comp, d)
    kd, pos = masked_l1_topk_batch(queries, pts, valid, k)
    ki = torch.where(pos >= 0, torch.gather(comp, -1, pos.long().clamp(min=0)), -1)
    return kd, ki.to(torch.int32), comparisons, overflow
