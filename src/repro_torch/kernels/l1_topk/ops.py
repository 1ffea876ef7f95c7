"""Wrapper of the masked L1 top-k kernel (``csrc/l1_topk.cu``, kernel C).

Replaces the JAX package's ``l1_topk_pallas``
(``repro/kernels/l1_topk/l1_topk.py``). It serves the staged pipeline's
distance stage (``BackendOps.l1_topk``), in kernel D's L1 order. Any k and
any width: a row's workspace moves from shared memory to a device scratch
when it does not fit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocking import next_pow2
from repro_torch.kernels.l1_topk import ref

TOPK_MAX = 32  # csrc/topk.cuh: the warp form's largest k
Q_SMEM_MAX = 8192  # csrc/l1_topk.cu L1_Q_SMEM_MAX: widest query in shared memory
_SMEM_MAX = 200 * 1024  # dynamic shared memory a block may ask for here
_SIGNATURES = {"l1_topk_launch": [_build.PTR] * 3 + [_build.INT] * 5 + [_build.PTR] * 4}


def workspace(c: int, d: int, k: int) -> tuple[int, bool]:
    """One row's workspace keys (one 64-bit key per position; a power of two
    of them for the block sort when k > TOPK_MAX) and whether they go to a
    device scratch because they and the query do not fit shared memory."""
    cap = c if k <= TOPK_MAX else next_pow2(c)
    q_bytes = d * 4 if d <= Q_SMEM_MAX else 0
    return cap, cap * 8 + q_bytes > _SMEM_MAX


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
    if not (k >= 1 and c >= 1 and d >= 1):
        raise ValueError(f"bad launch: k={k}, C={c}, d={d}")
    cap, spill = workspace(c, d, k)
    scratch = torch.empty((b * cap * 8,), dtype=torch.uint8, device=q.device) if spill else None
    dist = torch.empty((b, k), dtype=torch.float32, device=q.device)
    pos = torch.empty((b, k), dtype=torch.int32, device=q.device)
    lib = _build.library("l1_topk", _SIGNATURES)
    err = lib.l1_topk_launch(
        q.data_ptr(), cands.data_ptr(), mask.data_ptr(), b, c, d, k, cap,
        None if scratch is None else scratch.data_ptr(), dist.data_ptr(), pos.data_ptr(),
        _build.stream_ptr(q),
    )
    _build.check(lib, err, "l1_topk")
    return dist, pos
