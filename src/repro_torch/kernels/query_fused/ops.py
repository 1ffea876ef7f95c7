"""Wrappers of the fused query-tail kernels.

``query_tail`` (``csrc/query_fused.cu``, kernel D) replaces the JAX
package's ``query_tail_pallas`` (``repro/kernels/query_fused/query_fused.py``)
as the ``"cuda"`` backend's ``BackendOps.query_tail``: pipeline stages 3-5
(dedup -> compact -> gather + L1 + top-k) in one launch, equal to the staged
``ref.query_tail_ref``. ``query_tail_payload`` (``csrc/query_payload.cu``,
kernel E) replaces ``query_tail_payload_pallas`` as
``BackendOps.query_tail_payload``: the same stages 3-4, an approximate L1
over f16/i8 payload rows, a ``c_rerank`` shortlist reranked exactly in f32,
and the rerank-margin miss count, equal to ``ref.query_tail_payload_ref``.

The wrappers own the launch shape (:func:`launch_shape`): they pass the real
candidate width ``C`` (the kernels count the columns past it as ``-1``, so
nothing is padded or copied), the merge width ``cp`` (the next power of two)
and the run width the merge starts from when the run is a power of two (a
full in-block sort otherwise), and, for kernel D, how many blocks of a
thread-block cluster share a query and whether wide rows go through shared
memory. Kernel D's merge holds a query's whole row in one block: where the
merge width passes ``CP_MAX`` or the block's shared memory its budget,
:func:`launch_shape` says ``"hash"`` and the wrapper launches D's hash form
instead (kernel E's hash-set dedup, then D's L1 and top-k), whose
per-query arrays move to a device scratch when they do not fit shared
memory. Kernel E has the same dedup and scratch. So neither wrapper
refuses any k or any width, and each answers in one launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocking import next_pow2
from repro_torch.kernels.query_fused import ref

TOPK_MAX = 32  # csrc/topk.cuh: the warp form's largest k
QT_THREADS = 256  # csrc/tail_common.cuh: threads of a query's block
NARROW_D = 32  # csrc/tail_common.cuh QT_NARROW_D: one thread per row up to here
CP_MAX = 64 * QT_THREADS  # widest merge a block holds in registers
CLUSTER_MAX = 8  # csrc/query_fused.cu: blocks per query
E_THREADS = 512  # csrc/query_payload.cu: threads of a kernel-E block
_STAGE_MAX = 128 * 1024  # kernel D's row slots (one row per warp) may take this much
_SMEM_MAX = 200 * 1024  # dynamic shared memory a block may ask for here
_SIGNATURES = {
    "query_tail_launch": [_build.PTR] * 3 + [_build.INT] * 10 + [_build.PTR] * 5,
    "query_tail_hash_launch": [_build.PTR] * 3 + [_build.INT] * 7 + [_build.PTR, ctypes.c_longlong]
    + [_build.PTR] * 5,
}
_PAYLOAD_LAUNCH = [_build.PTR] * 5 + [_build.INT] * 8 + [_build.PTR, ctypes.c_longlong] + [_build.PTR] * 6
_PAYLOAD_SIGNATURES = {
    "query_tail_payload_f16_launch": _PAYLOAD_LAUNCH,
    "query_tail_payload_i8_launch": _PAYLOAD_LAUNCH,
}
_PAYLOAD_DTYPES = {torch.float16: "f16", torch.int8: "i8"}


def merge_shape(c: int, run: int) -> tuple[int, int]:
    """The merge width for ``c`` candidate columns (the next power of two)
    and the width the merge starts from: the run when it is a power of two
    (every aligned run of the row ascends, the columns past ``c`` included),
    else 1, a full sort."""
    cp = next_pow2(c)
    return cp, (min(run, cp) if run & (run - 1) == 0 else 1)


def cluster_size(q_n: int, d: int, sms: int) -> int:
    """Blocks of kernel D per query: 1 for narrow rows (every block of a
    cluster repeats the merge, which outweighs their gather) and when the
    queries alone fill the card; else the largest power of two up to
    ``CLUSTER_MAX`` that keeps the grid within two blocks per SM."""
    cs = 1
    if d > NARROW_D:
        while cs < CLUSTER_MAX and q_n * cs * 2 <= 2 * sms:
            cs *= 2
    return cs


def tail_smem_bytes(cp: int, c_comp: int, d: int, stage: bool) -> int:
    """Dynamic shared memory of one kernel-D block: the wide path's row
    slots (one row per warp), the query (an even number of floats), the
    merge's two exchange buffers, and the compacted indices with their
    distances (``tail_smem_bytes`` in ``csrc/query_fused.cu``)."""
    return ((QT_THREADS // 32 * d if stage else 0) + d + d % 2 + 2 * max(cp, QT_THREADS) + 2 * c_comp) * 4


def hash_ws_bytes(c: int, c_comp: int, d: int) -> int:
    """One query's workspace in kernel D's hash form (``HashLayout`` in
    ``csrc/query_fused.cu``): the hash set (``hash_slots(c)`` ints, which
    later hold the k > TOPK_MAX sort's keys), the compacted indices and
    their distances (``c_comp`` each) and the query, rounded up to 16
    bytes. In shared memory when it fits the budget, else in a device
    scratch of one workspace per query."""
    return -(-(hash_slots(c) + 2 * c_comp + d) * 4 // 16) * 16


@functools.lru_cache(maxsize=None)
def launch_shape(q_n: int, c: int, d: int, run: int, c_comp: int, *, k: int, aligned16: bool,
                 sms: int) -> dict:
    """Kernel D's launch for ``q_n`` queries of ``c`` candidates at width
    ``d``. The ``route`` is ``"fused"`` when the merge holds a query's row
    in one block (merge width within ``CP_MAX``, shared memory within
    budget without the wide path's row slots), else ``"hash"``: decided
    from the shape alone, k aside. A fused launch has the merge width
    ``cp`` and ``start``, the ``cluster`` size (1 when k > TOPK_MAX: the
    block-wide top-k runs in one block), ``stage`` (wide rows by cp.async
    through shared memory: needs d % 4 == 0, a 16-byte aligned data pointer
    and room) and the dynamic shared memory ``smem``; a hash launch its set's
    slots ``h_cap``, one query's workspace ``ws`` and whether it ``spill``s
    to a device scratch. Cached: a path asks for the same few shapes on
    every call. Read the result, do not change it."""
    cp, start = merge_shape(c, run)
    if cp > CP_MAX or tail_smem_bytes(cp, c_comp, d, False) > _SMEM_MAX:
        ws = hash_ws_bytes(c, c_comp, d)
        return dict(route="hash", h_cap=hash_slots(c), ws=ws, spill=ws > _SMEM_MAX)
    stage = (d > NARROW_D and d % 4 == 0 and aligned16 and QT_THREADS // 32 * d * 4 <= _STAGE_MAX
             and tail_smem_bytes(cp, c_comp, d, True) <= _SMEM_MAX)
    return dict(route="fused", cp=cp, start=start,
                cluster=cluster_size(q_n, d, sms) if k <= TOPK_MAX else 1, stage=stage,
                smem=tail_smem_bytes(cp, c_comp, d, stage))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if not (k >= 1 and c_comp >= 1 and run >= 1 and n >= 1):
        raise ValueError(f"bad launch: k={k}, c_comp={c_comp}, run={run}, n={n}")
    shape = launch_shape(q_n, c, d, run, c_comp, k=k, aligned16=data.data_ptr() % 16 == 0,
                         sms=_sm_count(data.device))
    kd = torch.empty((q_n, k), dtype=torch.float32, device=data.device)
    ki = torch.empty((q_n, k), dtype=torch.int32, device=data.device)
    comparisons = torch.empty((q_n,), dtype=torch.int32, device=data.device)
    overflow = torch.empty((q_n,), dtype=torch.int32, device=data.device)
    lib = _build.library("query_fused", _SIGNATURES)
    outs = (kd.data_ptr(), ki.data_ptr(), comparisons.data_ptr(), overflow.data_ptr(), _build.stream_ptr(data))
    if shape["route"] == "hash":
        scratch = (torch.empty((q_n * shape["ws"],), dtype=torch.uint8, device=data.device)
                   if shape["spill"] else None)
        err = lib.query_tail_hash_launch(
            data.data_ptr(), queries.data_ptr(), cand.data_ptr(), n, d, q_n, c, c_comp, k,
            shape["h_cap"], None if scratch is None else scratch.data_ptr(), shape["ws"], *outs,
        )
        _build.check(lib, err, "query_tail")
        _build.count_launch("query_tail.hash")
        return kd, ki, comparisons, overflow
    err = lib.query_tail_launch(
        data.data_ptr(), queries.data_ptr(), cand.data_ptr(), n, d, q_n, c,
        shape["cp"], shape["start"], c_comp, k, shape["cluster"], int(shape["stage"]), *outs,
    )
    _build.check(lib, err, "query_tail")
    return kd, ki, comparisons, overflow


def hash_slots(c: int) -> int:
    """The hash-set capacity of kernel E and of kernel D's hash form for rows
    of ``c`` candidates: a power of two, at least twice ``c`` (load at most
    1/2) and ``E_THREADS``."""
    return max(E_THREADS, next_pow2(2 * c))


def payload_ws_bytes(c: int, c_comp: int, cr: int, k: int, d: int) -> int:
    """One kernel-E query's workspace (``PayloadLayout`` in
    ``csrc/query_payload.cu``): the block sort's 64-bit keys when k or
    ``cr`` passes TOPK_MAX, the hash set, comp, ad and qerr (``c_comp``
    each), the shortlisted indices and their exact distances (``cr`` each)
    and the query, rounded up to 16 bytes. In shared memory when it fits the
    budget, else in a device scratch of one workspace per query."""
    sort = k > TOPK_MAX or cr > TOPK_MAX  # past the warp form: the block sort's keys
    keys = -(-next_pow2(cr) * 8 // 16) * 16 if sort else 0  # the set starts 16-byte aligned
    return -(-(keys + (hash_slots(c) + 3 * c_comp + 2 * cr + d) * 4) // 16) * 16


def query_tail_payload(
    data: torch.Tensor,  # (n, d) f32 exact rows (rerank only)
    qdata: torch.Tensor,  # (n, d) float16 | int8 quantized rows
    meta: torch.Tensor,  # (n, 2) f32 [dequant scale, L1 error bound]
    queries: torch.Tensor,  # (Q, d)
    cand: torch.Tensor,  # (Q, C) int32, run-sorted, -1 where masked
    *,
    run: int,
    c_comp: int,
    c_rerank: int,
    k: int,
) -> tuple[torch.Tensor, ...]:
    """Compressed-payload fused tail -> ``(kd, ki, comparisons, overflow,
    rerank_misses)``.

    Same candidate contract as :func:`query_tail`. The shortlist holds
    ``min(c_rerank, c_comp)`` rows. ``rerank_misses`` counts candidates left
    out of it whose approximate distance came within their quantization
    error bound of the k-th exact distance; zero certifies ``kd``/``ki``
    equal to :func:`query_tail`'s.
    """
    if data.device.type == "cpu":
        return ref.query_tail_payload_ref(
            data, qdata, meta, queries, cand, c_comp=c_comp, c_rerank=c_rerank, k=k
        )
    q_n, c = cand.shape
    n, d = data.shape
    queries = queries.to(torch.float32).contiguous()
    fmt = _PAYLOAD_DTYPES.get(qdata.dtype)
    if fmt is None:
        raise ValueError(f"qdata must be float16 or int8, not {qdata.dtype}")
    if not (data.dtype == meta.dtype == torch.float32 and cand.dtype == torch.int32):
        raise ValueError("data and meta must be float32 and cand int32")
    if qdata.shape != (n, d) or meta.shape != (n, 2) or queries.shape != (q_n, d):
        raise ValueError(
            f"qdata {tuple(qdata.shape)}, meta {tuple(meta.shape)} and queries"
            f" {tuple(queries.shape)} do not match data ({n}, {d}) and {q_n} rows"
        )
    tensors = (data, qdata, meta, queries, cand)
    if not all(t.is_contiguous() and t.device == data.device for t in tensors):
        raise ValueError("data, qdata, meta, queries and cand must be contiguous on one device")
    if not (k >= 1 and c_comp >= 1 and c_rerank >= 1 and run >= 1 and n >= 1 and c >= 1):
        raise ValueError(
            f"bad launch: k={k}, c_comp={c_comp}, c_rerank={c_rerank}, run={run}, n={n}, C={c}"
        )
    cr = min(c_rerank, c_comp)
    ws = payload_ws_bytes(c, c_comp, cr, k, d)
    scratch = torch.empty((q_n * ws,), dtype=torch.uint8, device=data.device) if ws > _SMEM_MAX else None
    kd = torch.empty((q_n, k), dtype=torch.float32, device=data.device)
    ki = torch.empty((q_n, k), dtype=torch.int32, device=data.device)
    counts = torch.empty((3, q_n), dtype=torch.int32, device=data.device)
    lib = _build.library("query_payload", _PAYLOAD_SIGNATURES)
    launch = getattr(lib, f"query_tail_payload_{fmt}_launch")
    err = launch(
        data.data_ptr(), qdata.data_ptr(), meta.data_ptr(), queries.data_ptr(),
        cand.data_ptr(), n, d, q_n, c, c_comp, cr, k, hash_slots(c),
        None if scratch is None else scratch.data_ptr(), ws, kd.data_ptr(), ki.data_ptr(),
        counts[0].data_ptr(), counts[1].data_ptr(), counts[2].data_ptr(), _build.stream_ptr(data),
    )
    _build.check(lib, err, "query_tail_payload")
    _build.count_launch(f"query_tail_payload.{fmt}")
    return kd, ki, counts[0], counts[1], counts[2]
