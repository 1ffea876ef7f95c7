"""Stable sorted-run merging for the chunked build (``repro.core.merge``).

Rows are ``(keys, idx)`` pairs sorted ascending by key with ties ascending
by index. Two sorted rows combine with :func:`merge_sorted_rows`, where the
left operand wins key ties; when every left index precedes every right
index the merge reproduces exactly what one stable full sort over the union
gives. The chunked builder folds per-chunk runs through the LSM-style ladder
below.
"""
from __future__ import annotations

import torch

# One ladder entry: (keys (T, s), idx (T, s)) — ``T`` table rows of one
# sorted length-``s`` run each.
Run = tuple[torch.Tensor, torch.Tensor]


def merge_sorted_rows(
    ak: torch.Tensor, ai: torch.Tensor, bk: torch.Tensor, bi: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable merge of sorted (keys, idx) rows; ``a`` wins key ties.

    Works on one row (n,) or a batch of rows (T, n): each element's output
    slot is its own position plus the count of the other side's elements
    that precede it (two binary searches, no re-sort).
    """
    n, m = ak.shape[-1], bk.shape[-1]
    dev = ak.device
    pa = torch.arange(n, device=dev) + torch.searchsorted(bk, ak, side="left")
    pb = torch.arange(m, device=dev) + torch.searchsorted(ak, bk, side="right")
    shape = ak.shape[:-1] + (n + m,)
    keys = ak.new_zeros(shape).scatter_(-1, pa, ak).scatter_(-1, pb, bk)
    idx = ai.new_zeros(shape).scatter_(-1, pa, ai).scatter_(-1, pb, bi)
    return keys, idx


def merge_run_pair(a: Run, b: Run) -> Run:
    """Merge two multi-table runs row-wise (``a`` older: it wins key ties)."""
    return merge_sorted_rows(a[0], a[1], b[0], b[1])


def ladder_push(stack: list[Run], item: Run, merge_fn=merge_run_pair) -> None:
    """Push one sorted run onto the binary-counter ladder.

    ``stack`` holds runs oldest-first with strictly decreasing sizes; a new
    run folds into the top while the top is no larger, so merging ``c``
    equal chunks costs O(n log c).
    """
    while stack and stack[-1][0].shape[-1] <= item[0].shape[-1]:
        item = merge_fn(stack.pop(), item)
    stack.append(item)


def ladder_collapse(stack: list[Run], merge_fn=merge_run_pair) -> Run:
    """Fold a non-empty ladder into one fully sorted run (oldest wins ties)."""
    acc = stack.pop()
    while stack:
        acc = merge_fn(stack.pop(), acc)
    return acc
