"""Plain PyTorch versions of the signature-packing kernels (``csrc/hash_pack.cu``).

Same functions as the kernels on the same flat column layout: table ``t``
owns columns ``[t*m_pad, (t+1)*m_pad)``, ``m_pad`` a multiple of 32, and word
``w`` of a row packs columns ``[32w, 32w+32)`` (bit ``j`` = column
``32w + j``). Words are int64 holding 32-bit values.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import pack_bits


def bitsample_pack_ref(
    x: torch.Tensor,  # (T, d) f32
    dims: torch.Tensor,  # (M,) int32 sampled coordinate per column
    thrs: torch.Tensor,  # (M,) f32, +inf on padded columns
    margins: bool = False,
):
    """``words = pack32(x[:, dims] > thrs)`` -> (T, M/32) [, ``|x[:, dims] -
    thrs|`` (T, M)]."""
    g = x[:, dims.long()]
    words = pack_bits(g > thrs)
    return (words, (g - thrs).abs()) if margins else words


def proj_sign_pack_ref(
    x: torch.Tensor,  # (T, d) f32
    proj: torch.Tensor,  # (d, M) f32
    bias: torch.Tensor,  # (M,) f32
    m: int,
    m_pad: int,
    margins: bool = False,
):
    """``s = x @ proj + bias``; ``words = pack32(s >= 0 & col % m_pad < m)``
    -> (T, M/32) [, ``|s|`` (T, M)]. The product is a float32 matmul; on the
    card its precision follows ``torch.backends.cuda.matmul.allow_tf32``,
    which the caller keeps False (PyTorch's default)."""
    s = x @ proj + bias
    col = torch.arange(proj.shape[1], device=x.device)
    words = pack_bits((s >= 0.0) & (col % m_pad < m))
    return (words, s.abs()) if margins else words
