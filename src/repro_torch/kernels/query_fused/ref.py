"""Plain PyTorch versions of the fused query tails (``csrc/query_fused.cu``,
kernel D, and ``csrc/query_payload.cu``, kernel E).

Pipeline stages 3-5 in their staged form — full-width sort dedup, sentinel
sort-compact, masked L1 top-k — over the same (Q, C) candidate tensor the
kernels consume. Unlike the kernels, rows need no run structure here.
"""
from __future__ import annotations

import torch

from repro_torch.core import topk

SENT = 2**31 - 1  # sorts after any real index
INF = float("inf")


def _dedup_compact(
    cand: torch.Tensor, c_comp: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stages 3-4 -> ``(comp (Q, cc) with -1 pads, valid, comparisons,
    overflow)``: the first ``c_comp`` unique indices of each row, ascending."""
    cand_sorted = torch.sort(cand, dim=-1).values
    uniq = torch.ones_like(cand_sorted, dtype=torch.bool)
    uniq[:, 1:] = cand_sorted[:, 1:] != cand_sorted[:, :-1]
    uniq &= cand_sorted >= 0
    comparisons = uniq.sum(dim=-1, dtype=torch.int32)
    comp = torch.sort(torch.where(uniq, cand_sorted, SENT), dim=-1).values[:, :c_comp]
    valid = comp != SENT
    overflow = (comparisons - c_comp).clamp(min=0)
    return torch.where(valid, comp, -1), valid, comparisons, overflow


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
    comp, valid, comparisons, overflow = _dedup_compact(cand, c_comp)
    pts = data[comp.long().clamp(0, n - 1)]  # (Q, c_comp, d)
    kd, pos = topk.masked_l1_topk_batch(queries, pts, valid, k)
    ki = torch.where(pos >= 0, torch.gather(comp, -1, pos.long().clamp(min=0)), -1)
    return kd, ki.to(torch.int32), comparisons, overflow


def query_tail_payload_ref(
    data: torch.Tensor,  # (n, d) exact f32 rows (rerank only)
    qdata: torch.Tensor,  # (n, d) float16 | int8 quantized rows
    meta: torch.Tensor,  # (n, 2) f32 [dequant scale, L1 error bound]
    queries: torch.Tensor,  # (Q, d)
    cand: torch.Tensor,  # (Q, C) int32, -1 where masked
    *,
    c_comp: int,
    c_rerank: int,
    k: int,
) -> tuple[torch.Tensor, ...]:
    """The compressed-payload tail -> ``(kd, ki, comparisons, overflow,
    rerank_misses)``, following ``repro.kernels.query_fused.ref``.

    Stages 3-4 as in :func:`query_tail_ref`. The approximate distance of
    each compacted row, ``ad = sum_j |qdata[j] * scale - q[j]|``, is summed
    over ``j`` in ascending order one rounded add at a time, as the kernel
    sums it, so ``ad`` and everything chosen from it agree exactly with the
    kernel's. The shortlist is the ``min(c_rerank, cc)`` smallest ``ad``
    by a stable sort (ties to the lower compacted position; infinite
    entries fill it when too few are valid). Its valid rows are reranked
    exactly in f32 with :func:`~repro_torch.core.topk.l1_distances_batch`,
    scattered back to position order (inf elsewhere), and the top-k is
    taken in that order. A miss is a valid row outside the shortlist with
    ``ad - qerr <= kd[:, k-1]``; no miss certifies ``kd``/``ki`` equal to
    :func:`query_tail_ref`'s.
    """
    n = data.shape[0]
    comp, valid, comparisons, overflow = _dedup_compact(cand, c_comp)
    safe = comp.long().clamp(0, n - 1)
    mrows = meta[safe]  # (Q, cc, 2)
    diff = (qdata[safe].to(torch.float32) * mrows[..., 0:1] - queries[:, None, :]).abs()
    ad = torch.zeros_like(diff[..., 0])
    for j in range(diff.shape[-1]):
        ad = ad + diff[..., j]
    ad = torch.where(valid, ad, INF)
    qerr = mrows[..., 1]

    cr = min(c_rerank, ad.shape[1])
    spos = torch.sort(ad, dim=-1, stable=True).indices[:, :cr]
    svalid = torch.gather(valid, 1, spos)
    pts = data[torch.gather(safe, 1, spos)]  # (Q, cr, d)
    ed = torch.where(svalid, topk.l1_distances_batch(queries, pts), INF)
    ed_full = torch.full_like(ad, INF).scatter(1, spos, ed)
    positions = torch.arange(ad.shape[1], dtype=torch.int32, device=ad.device)
    kd, pos = topk.masked_topk_smallest(ed_full, positions.expand(ad.shape), k)
    ki = torch.where(pos >= 0, torch.gather(comp, -1, pos.long().clamp(min=0)), -1)

    in_short = torch.zeros_like(valid).scatter(1, spos, True)
    miss = valid & ~in_short & (ad - qerr <= kd[:, k - 1 : k])
    return kd, ki.to(torch.int32), comparisons, overflow, miss.sum(dim=-1, dtype=torch.int32)
