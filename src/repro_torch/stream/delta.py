"""Delta segments: fixed-capacity, append-only per-cell index overlays.

Counterpart of ``repro.stream.delta``. A ``DeltaIndex`` absorbs streamed-in
points without touching the base CSR tables (DESIGN.md §9). Each occupied
slot holds the outer bucket keys (one per local table) and inner-layer
keys of one inserted point; the point itself lives in the owning store.
Slots fill in arrival order, which is also ascending global-index order —
the invariant the exact base+delta merge (``pipeline._merge_capped``)
relies on.

The slot count and drop count are host ints: the streaming core decides overflow
and maintenance from them without reading the device. Writes are
out-of-place (a new key tensor per append), so a snapshot that shares the
old segment keeps answering from it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import pipeline


class DeltaIndex(NamedTuple):
    outer_keys: torch.Tensor  # (cap, L) int64 bucket key per outer table
    inner_keys: torch.Tensor  # (cap, L_in) int64 inner-layer keys
    count: int  # occupied slots
    dropped: int  # inserts dropped on overflow


def make_delta(cap: int, l_out: int, l_in: int, device: torch.device | str) -> DeltaIndex:
    """An empty delta segment with ``cap`` slots on ``device``."""
    return DeltaIndex(
        outer_keys=torch.zeros((cap, l_out), dtype=torch.int64, device=device),
        inner_keys=torch.zeros((cap, l_in), dtype=torch.int64, device=device),
        count=0,
        dropped=0,
    )


def append_keys(
    delta: DeltaIndex,
    outer_keys: torch.Tensor,  # (B, L)
    inner_keys: torch.Tensor,  # (B, L_in)
    room: int,  # usable slots (<= cap; the store may bound it)
) -> DeltaIndex:
    """Write one batch of hashed points into the next free slots.

    Slots ``[count, min(count + B, room))`` are written; the rest of the
    batch is dropped and counted. The batch is cut to the slots that fit
    before the write (the JAX package's out-of-range ``mode="drop"``).
    """
    b = outer_keys.shape[0]
    fit = max(0, min(b, room - delta.count))
    slots = torch.arange(delta.count, delta.count + fit, device=delta.outer_keys.device)
    return DeltaIndex(
        outer_keys=delta.outer_keys.index_copy(0, slots, outer_keys[:fit]),
        inner_keys=delta.inner_keys.index_copy(0, slots, inner_keys[:fit]),
        count=delta.count + fit,
        dropped=delta.dropped + (b - fit),
    )


def as_view(delta: DeltaIndex, base_n: int) -> pipeline.DeltaView:
    """Expose the segment to the pipeline's gather stage: slot ``s`` holds
    the point with global index ``base_n + s`` (base indices all precede
    delta indices)."""
    cap = delta.outer_keys.shape[0]
    slots = torch.arange(cap, dtype=torch.int32, device=delta.outer_keys.device)
    return pipeline.DeltaView(
        outer_keys=delta.outer_keys,
        inner_keys=delta.inner_keys,
        gidx=base_n + slots,
        valid=slots < delta.count,
    )
