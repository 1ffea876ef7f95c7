"""Wrapper of the masked L1 top-k kernel (``csrc/l1_topk.cu``, kernel C).

Replaces the JAX package's ``l1_topk_pallas``
(``repro/kernels/l1_topk/l1_topk.py``). It serves the staged pipeline's
distance stage (``BackendOps.l1_topk``); on the ``"cuda"`` backend the query
path runs the fused tail instead, whose top-k is this kernel's device
function (``csrc/topk.cuh``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l1_topk import ref

TOPK_MAX = 32  # csrc/topk.cuh
_SIGNATURES = {"l1_topk_launch": [_build.PTR] * 3 + [_build.INT] * 4 + [_build.PTR] * 3}


def l1_topk(
    q: torch.Tensor, cands: torch.Tensor, mask: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, d), cands (B, C, d) f32, mask (B, C) bool -> dists (B, k)
    ascending (inf pad) and int32 positions into C (-1 pad), ties to the
    lowest position."""
    if q.device.type == "cpu":
        return ref.l1_topk_ref(q, cands, mask, k)
    b, c, d = cands.shape
    if not (q.shape == (b, d) and mask.shape == (b, c)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, cands {(b, c, d)}, mask {tuple(mask.shape)}")
    if not (q.dtype == cands.dtype == torch.float32 and mask.dtype == torch.bool):
        raise ValueError("q and cands must be float32 and mask bool")
    if not all(t.is_contiguous() and t.device == q.device for t in (q, cands, mask)):
        raise ValueError("q, cands and mask must be contiguous on one device")
    if not 1 <= k <= TOPK_MAX:
        raise ValueError(f"k={k} outside [1, {TOPK_MAX}]")
    dist = torch.empty((b, k), dtype=torch.float32, device=q.device)
    pos = torch.empty((b, k), dtype=torch.int32, device=q.device)
    lib = _build.library("l1_topk", _SIGNATURES)
    err = lib.l1_topk_launch(
        q.data_ptr(), cands.data_ptr(), mask.data_ptr(), b, c, d, k,
        dist.data_ptr(), pos.data_ptr(), _build.stream_ptr(q),
    )
    _build.check(lib, err, "l1_topk")
    return dist, pos
