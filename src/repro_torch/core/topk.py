"""Masked top-K-smallest utilities and K-NN merge (the paper's Reducer op).

Counterpart of ``repro.core.topk``. ``lax.top_k`` breaks ties toward the
lowest position; ``torch.topk`` makes no such promise, so every selection
here is a stable ascending sort cut to ``k``.
"""
from __future__ import annotations

from typing import Callable

import torch

INF = float("inf")


def masked_topk_smallest(
    dists: torch.Tensor, idx: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest distances along the last axis, inf/-1 padded.

    dists: (..., C) float, inf where invalid. idx: (..., C) int, -1 where
    invalid. Returns (..., k) distances ascending and matching indices;
    ties go to the lowest position.
    """
    c = dists.shape[-1]
    if c < k:  # pad so the cut is well defined
        pad = k - c
        dists = torch.cat([dists, dists.new_full(dists.shape[:-1] + (pad,), INF)], -1)
        idx = torch.cat([idx, idx.new_full(idx.shape[:-1] + (pad,), -1)], -1)
    top, pos = torch.sort(dists, dim=-1, stable=True)
    top, pos = top[..., :k], pos[..., :k]
    return top, torch.where(torch.isfinite(top), torch.gather(idx, -1, pos), -1)


def masked_unique_topk_smallest(
    dists: torch.Tensor, idx: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`masked_topk_smallest` with duplicate indices collapsed first,
    along the last axis (..., C).

    Cells of one node share its points, so one point can surface in
    several partial top-Ks; duplicates carry one distance, so keeping the
    first occurrence is exact. Entries are taken in ascending index order
    (a stable sort, as the JAX package's ``argsort``), so distance ties go
    to the lower index.
    """
    order = torch.sort(idx, dim=-1, stable=True).indices
    idx_s = torch.gather(idx, -1, order)
    dist_s = torch.gather(dists, -1, order)
    uniq = torch.ones_like(idx_s, dtype=torch.bool)
    uniq[..., 1:] = idx_s[..., 1:] != idx_s[..., :-1]
    uniq &= idx_s >= 0
    return masked_topk_smallest(
        torch.where(uniq, dist_s, INF), torch.where(uniq, idx_s, -1), k
    )


def merge_topk(
    dists_a: torch.Tensor, idx_a: torch.Tensor,
    dists_b: torch.Tensor, idx_b: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two K-NN partial results (the Reducer's reduction operation)."""
    return masked_topk_smallest(
        torch.cat([dists_a, dists_b], -1), torch.cat([idx_a, idx_b], -1), k
    )


def l1_distances(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """q: (d,), pts: (C, d) -> (C,) l1 distances."""
    return (pts - q[None, :]).abs().sum(dim=-1)


def l1_distances_batch(q: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """q: (Q, d), cands: (Q, C, d) -> (Q, C) l1 distances."""
    return (cands - q[:, None, :]).abs().sum(dim=-1)


def masked_l1_topk_batch(
    q: torch.Tensor, cands: torch.Tensor, mask: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain distance/top-k stage of the staged pipeline.

    q: (Q, d); cands: (Q, C, d); mask: (Q, C) bool (False = padded slot).
    Returns dists (Q, k) ascending (inf where fewer than k valid) and int32
    positions (Q, k) into C (-1 pad); ties go to the lower position.
    """
    dists = torch.where(mask, l1_distances_batch(q, cands), INF)
    pos = torch.arange(dists.shape[1], dtype=torch.int32, device=dists.device)
    return masked_topk_smallest(dists, pos.expand(dists.shape), k)


def topk_mismatch(
    dist: torch.Tensor, idx: torch.Tensor,
    ref_dist: torch.Tensor, ref_idx: torch.Tensor,
    dist_of: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    rtol: float = 1e-5, atol: float = 1e-5,
) -> str | None:
    """Why the top-k result ``(dist, idx)`` (Q, k) is not an equal answer to
    ``(ref_dist, ref_idx)``, or ``None`` when it is.

    Distances must agree within ``rtol``/``atol`` at every slot (inf with
    inf), since two implementations may sum over d in another order. An
    index may differ from the reference only at a real tie: where the
    reference's distance at that slot equals its distance at a neighbouring
    slot, or at the last slot, whose tie may be with the unseen (k+1)-th
    neighbour. There the index must still be a point at the reported
    distance, which ``dist_of(rows, idx) -> (N,)`` recomputes from the data.
    No row may repeat an index more often than the reference's row does (a
    grid's Reducer keeps a point that two cells of one node both found).
    """
    if dist.shape != ref_dist.shape or idx.shape != ref_idx.shape:
        return f"shapes {tuple(dist.shape)}/{tuple(idx.shape)} differ from the reference"

    def close(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.isclose(a, b, rtol=rtol, atol=atol) | (torch.isinf(a) & torch.isinf(b))

    off = ~close(dist, ref_dist)
    if off.any():
        return f"{int(off.sum())} distances differ beyond rtol={rtol}, atol={atol}"
    tie = torch.zeros_like(off)
    tie[:, -1] = True
    level = close(ref_dist[:, 1:], ref_dist[:, :-1])
    tie[:, 1:] |= level
    tie[:, :-1] |= level
    diff = idx != ref_idx
    if (diff & ~tie).any():
        return f"{int((diff & ~tie).sum())} indices differ at slots without a distance tie"
    rows, slots = diff.nonzero(as_tuple=True)
    moved = idx[rows, slots]
    if (moved < 0).any():
        return "padding where the reference holds a point"
    if rows.numel() and not close(dist_of(rows, moved), dist[rows, slots]).all():
        return "a tied index is not a point at its reported distance"
    if (_repeats(idx) > _repeats(ref_idx)).any():
        return "a row repeats an index more often than the reference's row does"
    return None


def _repeats(idx: torch.Tensor) -> torch.Tensor:
    """Per row, how many entries repeat an earlier index (-1 pads aside)."""
    srt = idx.sort(dim=1).values
    return ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum(dim=1)

