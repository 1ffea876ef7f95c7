"""Micro-batch coalescing onto the static-shape query path (DESIGN.md §15);
a copy of ``repro.serve.coalesce``.

A front end that forwarded each request's natural batch size would hand
the query path a new shape on nearly every arrival (in the JAX package a
recompile; here a new set of launch shapes). The coalescer keeps the
shapes to a small fixed **bucket ladder** of batch sizes (default ``(8,
32, 128, 512)``): queued requests are packed whole into one micro-batch,
the batch's row count is padded up to the smallest ladder rung that fits,
and the padding rows (copies of the first real row — always in-domain for
the §8.3 value hashing) are computed and discarded. Steady-state serving
therefore touches at most ``len(ladder)`` query shapes per degradation
level, and ``obs.query_retraces`` pins that no kernel library is built
after warmup (tests/test_torch_frontend.py).

The packing contract the tests hold (tests/test_torch_frontend.py):

* every queued request lands in **exactly one** micro-batch (requests
  are never split across batches or duplicated);
* the chosen bucket is the **smallest** rung ≥ the real row count, so
  padding never exceeds the gap to the next rung;
* per-request result rows are **bit-identical** to a solo
  ``Index.query`` of that request's queries when no degradation fired —
  the pipeline is row-independent, and the coalescer only ever
  concatenates and pads rows.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np

#: Default pad-to-bucket batch-size ladder. Small enough that warmup
#: runs every shape in a few calls, wide enough that padding waste is
#: bounded by the rung ratio (≤ 4x here, and only on the smallest rungs).
BUCKET_LADDER: tuple[int, ...] = (8, 32, 128, 512)


def bucket_for(n: int, ladder: tuple[int, ...] = BUCKET_LADDER) -> int:
    """The smallest ladder rung ≥ ``n`` (the pad-to shape for ``n`` rows).

    >>> bucket_for(1), bucket_for(8), bucket_for(9), bucket_for(512)
    (8, 8, 32, 512)
    """
    if n < 1 or n > ladder[-1]:
        raise ValueError(f"n={n} outside the ladder (1..{ladder[-1]})")
    return ladder[bisect.bisect_left(ladder, n)]


@dataclasses.dataclass
class MicroBatch:
    """One coalesced micro-batch headed for the query path.

    ``requests`` are the packed front-end requests in slot order;
    ``spans[i] = (lo, hi)`` is request ``i``'s row range inside
    ``queries``; rows ``n_real:`` of ``queries`` are padding (copies of
    row 0) whose results are discarded. ``deadline_at`` is the tightest
    absolute deadline in the batch (+inf when nobody has one) — the §15
    scheduler derives the batch's degradation budget from it.
    """

    requests: list
    queries: np.ndarray  # (bucket, d) float32, rows n_real: are padding
    spans: list[tuple[int, int]]
    n_real: int
    bucket: int
    deadline_at: float

    @property
    def padding(self) -> int:
        """Padding rows appended to reach the bucket shape."""
        return self.bucket - self.n_real


class Coalescer:
    """Packs deadline-ordered queued requests into ladder-shaped batches.

    ``form`` takes requests *whole* (a request's queries always share one
    micro-batch — that is what makes per-request slicing trivial and the
    exactness contract per-request) greedily from the front of the given
    queue until the next request would overflow the top rung, removes
    them from the queue, and pads to the smallest fitting rung. The
    caller owns the queue order; the §15 front end sorts by deadline
    slack first (earliest-deadline-first), so the tightest requests ride
    the earliest batch.
    """

    def __init__(self, ladder: tuple[int, ...] = BUCKET_LADDER):
        ladder = tuple(int(r) for r in ladder)
        if not ladder or list(ladder) != sorted(set(ladder)) or ladder[0] < 1:
            raise ValueError(
                f"ladder {ladder!r} must be strictly ascending positive rungs"
            )
        self.ladder = ladder

    @property
    def max_rows(self) -> int:
        """The top rung — the most query rows one micro-batch can carry
        (and the largest request the front end admits)."""
        return self.ladder[-1]

    def form(self, queue: list) -> MicroBatch | None:
        """Pack a micro-batch from the front of ``queue`` (None if empty).

        Packed requests are removed from ``queue``; requests left behind
        ride a later batch — exactly-once delivery falls out of this
        pop-from-queue discipline (property-tested).
        """
        if not queue:
            return None
        taken, rows = [], 0
        while queue and rows + queue[0].queries.shape[0] <= self.max_rows:
            req = queue.pop(0)
            taken.append(req)
            rows += req.queries.shape[0]
        if not taken:  # head request alone overflows the ladder
            raise ValueError(
                f"request with {queue[0].queries.shape[0]} queries exceeds"
                f" the ladder's top rung {self.max_rows} — reject at submit"
            )
        bucket = bucket_for(rows, self.ladder)
        spans, lo = [], 0
        for req in taken:
            hi = lo + req.queries.shape[0]
            spans.append((lo, hi))
            lo = hi
        q = np.concatenate([r.queries for r in taken], axis=0)
        if bucket > rows:  # pad with the first real row (in-domain values)
            pad = np.broadcast_to(q[:1], (bucket - rows, q.shape[1]))
            q = np.concatenate([q, pad], axis=0)
        deadline_at = min(r.deadline_at for r in taken)
        return MicroBatch(
            requests=taken, queries=np.ascontiguousarray(q, np.float32),
            spans=spans, n_real=rows, bucket=bucket, deadline_at=deadline_at,
        )
