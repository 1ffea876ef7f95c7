"""Padding and launch-shape helpers shared by the kernel wrappers.

Counterpart of ``repro.kernels.blocking`` without its interpret-mode policy,
which has nothing to decide here: a wrapper takes its plain version for a
CPU tensor and launches its kernel for a CUDA tensor.
"""
from __future__ import annotations

import torch


def round_up(n: int, mult: int) -> int:
    """Smallest multiple of ``mult`` >= ``n``."""
    return -(-n // mult) * mult


def pad_axis(x: torch.Tensor, axis: int, mult: int, value=0) -> torch.Tensor:
    """Right-pad ``axis`` of ``x`` to a multiple of ``mult`` with ``value``."""
    rem = (-x.shape[axis]) % mult
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (1 for ``n <= 1``)."""
    return 1 << max(0, n - 1).bit_length()
