"""Wrapper of the fused query-tail kernel (``csrc/query_fused.cu``, kernel D).

Replaces the JAX package's ``query_tail_pallas``
(``repro/kernels/query_fused/query_fused.py``) as the ``"cuda"`` backend's
``BackendOps.query_tail``: pipeline stages 3-5 (dedup -> compact -> gather +
L1 + top-k) in one launch, equal to the staged ``ref.query_tail_ref``. The
wrapper owns the launch shape: it pads the candidate width with ``-1``
columns to a multiple of ``run`` holding a power-of-two number of runs, as
``repro/kernels/query_fused/ops.py`` does, and the kernel merges runs from
the run width up when the run is a power of two (a full in-block sort
otherwise).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocking import next_pow2, pad_axis, round_up
from repro_torch.kernels.query_fused import ref

TOPK_MAX = 32  # csrc/topk.cuh
_SMEM_MAX = 200 * 1024  # dynamic shared memory a block may ask for here
_SIGNATURES = {"query_tail_launch": [_build.PTR] * 3 + [_build.INT] * 8 + [_build.PTR] * 5}


def _run_padded_width(c: int, run: int) -> int:
    """The next multiple of ``run`` holding a power-of-two number of runs."""
    return run * next_pow2(round_up(max(c, 1), run) // run)


def query_tail(
    data: torch.Tensor,  # (n, d) f32
    queries: torch.Tensor,  # (Q, d)
    cand: torch.Tensor,  # (Q, C) int32, run-sorted, -1 where masked
    *,
    run: int,
    c_comp: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused tail -> ``(kd, ki, comparisons, overflow)``.

    ``cand`` rows must be run-sorted: every ``run``-aligned slice ascends,
    with ``-1`` only as trailing padding inside its slice — what the
    pipeline's gather emits for ``run = gcd(c_max, c_in, slot)``.
    """
    if data.device.type == "cpu":
        return ref.query_tail_ref(data, queries, cand, c_comp=c_comp, k=k)
    q_n, c = cand.shape
    n, d = data.shape
    queries = queries.to(torch.float32).contiguous()
    if not (data.dtype == torch.float32 and cand.dtype == torch.int32):
        raise ValueError("data must be float32 and cand int32")
    if queries.shape != (q_n, d):
        raise ValueError(f"queries {tuple(queries.shape)} do not match ({q_n}, {d})")
    if not all(t.is_contiguous() and t.device == data.device for t in (data, queries, cand)):
        raise ValueError("data, queries and cand must be contiguous on one device")
    if not (1 <= k <= TOPK_MAX and c_comp >= 1 and run >= 1 and n >= 1):
        raise ValueError(f"bad launch: k={k}, c_comp={c_comp}, run={run}, n={n}")
    c_pad = _run_padded_width(c, run)
    cand = pad_axis(cand, 1, c_pad, value=-1).contiguous()
    cp = next_pow2(c_pad)
    start = run if (run & (run - 1)) == 0 and cp == c_pad else 1
    if (cp + 2 * c_comp) * 4 > _SMEM_MAX:
        raise ValueError(f"candidate width {cp} with c_comp={c_comp} exceeds shared memory")
    kd = torch.empty((q_n, k), dtype=torch.float32, device=data.device)
    ki = torch.empty((q_n, k), dtype=torch.int32, device=data.device)
    comparisons = torch.empty((q_n,), dtype=torch.int32, device=data.device)
    overflow = torch.empty((q_n,), dtype=torch.int32, device=data.device)
    lib = _build.library("query_fused", _SIGNATURES)
    err = lib.query_tail_launch(
        data.data_ptr(), queries.data_ptr(), cand.data_ptr(), n, d, q_n, c_pad,
        cp, start, c_comp, k, kd.data_ptr(), ki.data_ptr(),
        comparisons.data_ptr(), overflow.data_ptr(), _build.stream_ptr(data),
    )
    _build.check(lib, err, "query_tail")
    return kd, ki, comparisons, overflow
