"""The table of peaks and the bound arithmetic (frozen from ``chip_smoke.py``),
and the work of the fused query tail (kernel D) counted from its inputs.

The bound of a call is the larger of its bytes over the device memory's
bandwidth and its operations over the float32 rate outside the tensor
cores: NVIDIA's data sheet for one H100 SXM at its full 700 W.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def bound_s(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> float:
    """The least time the chip could take for ``nbytes`` and ``ops``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def tail_work(comparisons: int, queries: int, cand_width: int, d: int, k: int) -> tuple[float, float]:
    """Bytes and operations of kernel D over ``queries`` (cell, query) pairs
    holding ``comparisons`` distinct candidates in all: each compared
    candidate's row (d float32) and each query's row read once, each query's
    candidate ids (``cand_width`` int32) read once, k distances and k ids
    written; three operations (subtract, absolute value, add) a compared
    coordinate."""
    nbytes = 4.0 * (comparisons * d + queries * (d + cand_width + 2 * k))
    return nbytes, 3.0 * comparisons * d
