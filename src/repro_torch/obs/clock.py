"""Clock helpers (a copy of ``repro.obs.clock``).

* :func:`monotonic` — ``time.perf_counter``: every duration and deadline
  is measured on it, so a wall-clock jump never expires a deadline.
* :func:`wall` — ``time.time``: epoch seconds for human-readable
  timestamps only, never durations.
"""
from __future__ import annotations

import time


def monotonic() -> float:
    """Monotonic seconds, for durations and deadlines."""
    return time.perf_counter()


def wall() -> float:
    """Wall-clock epoch seconds, for timestamps only."""
    return time.time()
