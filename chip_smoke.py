"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs six
phases, printing one JSON line each; any failed check raises, so the script
exits non-zero:

1. ``device``     the card's name and power limit (``nvidia-smi``).
2. ``kernels``    each hand-written kernel against its plain PyTorch version
                  on the card, at the shapes the main path gives it, timed
                  with CUDA events (cold L2) beside its bound: A, B (words,
                  and apart its margins mode), C and D on one grid cell's
                  shapes, and E (the payload tail, f16 and i8) on the first
                  50-query chunk of a single shard over every point.
3. ``main_path``  the paper's scale: 1,370,000 synthetic ABP windows (d=30)
                  on the 40-cell ``grid(nu=10, p=4)`` with the ``"cuda"``
                  backend, 2000 out-of-sample queries, DSLSH against the
                  exhaustive PKNN baseline (MCC, comparisons, speedup).
   ``query_profile`` a profiled 200-query grid query: wall time, summed
                  kernel time on the card and the device's idle share.
4. ``multiprobe`` a single-shard index with ``multiprobe=2``, so the
                  words+margins kernel runs on the query path.
5. ``backends_agree`` the ``"torch"`` backend on the card answers the first
                  256 queries as the ``"cuda"`` backend does.
6. ``payload``    the compressed-payload path: ``single()`` over all
                  1,370,000 windows with ``c_rerank=32``, built and queried
                  (the same 2000 queries) as f32, f16 and i8 in turn; one
                  payload-tail launch per 50-query chunk, every query with
                  no rerank miss equal to the f32 shard's answer, and each
                  compressed MCC within 0.01 of the f32 shard's.
   ``payload_profile`` per format, a profiled 200-query single-shard query,
                  as ``query_profile``.

The ``kernels`` line comes last but two, then the ``nvidia-smi`` line, and
the last line is ``{"ok": true, "device": {...}}``. A kernel's ``launches``
counts the path it belongs to: the main path for A-D, the payload phase's
two compressed queries for E. Without a CUDA device, or without the
repository's ``src/`` beside it, the script exits non-zero before printing
any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RTOL = ATOL = 1e-5  # distances: the kernels sum over d in another order

# the paper-scale configuration of benchmarks/scale_bench.py and
# benchmarks/common.py (slsh_cfg)
CFG = dict(
    m_out=32, L_out=16, m_in=12, L_in=4, alpha=0.005, k=10,
    val_lo=20.0, val_hi=180.0, c_max=256, c_in=16, h_max=16, p_max=512,
    build_chunk=4096, query_chunk=50,
)
N, NQ, NU, P, SEED = 1_370_000, 2_000, 10, 4, 0
C_RERANK = 32  # the payload shortlist of benchmarks/scale_bench.py:48


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def need(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def timed_ms(fn, iters: int, flush) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, each started with a
    cold L2 (``flush`` overwrites a buffer larger than the cache first)."""
    import torch

    fn()  # warm-up
    total = 0.0
    for _ in range(iters):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def profile_activities(dev) -> list:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def profile_query(dev, fn, queries: int = 200) -> dict:
    """Wall time of ``fn()`` under the profiler, the summed time of its
    kernels on the card (device busy) and the device's idle share."""
    import torch

    with torch.profiler.profile(activities=profile_activities(dev)) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return dict(
        queries=queries, wall_s=wall,
        device_busy_s=busy if events else None,
        device_idle_share=1.0 - busy / wall if events else None,
        top_kernels=[dict(name=e.key[:90], ms=e.self_device_time_total / 1e3, calls=e.count) for e in top],
    )


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def need_topk(kd, ki, kd_ref, ki_ref, dist_of, what: str) -> None:
    """``(kd, ki)`` answers as ``(kd_ref, ki_ref)`` does: distances within
    tolerance, and an index differs only at a real distance tie, where it
    must be a point at its distance (``repro_torch.core.topk.topk_mismatch``)."""
    from repro_torch.core import topk

    why = topk.topk_mismatch(kd, ki, kd_ref, ki_ref, dist_of, rtol=RTOL, atol=ATOL)
    need(why is None, f"{what}: {why}")


def point_dist_of(data, queries):
    """L1 distance of query ``rows`` to data points ``idx``."""
    return lambda rows, idx: (data[idx.long()] - queries[rows]).abs().sum(-1)


def synth(n: int, nq: int):
    from repro_torch.data import windows

    pts = np.empty((n, windows.D_SUBWINDOWS), np.float32)
    labs = np.empty((n,), np.int8)
    lo = 0
    for p, y in windows.synth_window_chunks(windows.SyntheticWindowSpec(n=n, seed=SEED), 16_384):
        pts[lo : lo + p.shape[0]], labs[lo : lo + p.shape[0]] = p, y
        lo += p.shape[0]
    qx, qy = windows.synth_window_slice(windows.SyntheticWindowSpec(n=n + nq, seed=SEED), n, n + nq)
    return pts, labs, qx, qy


def kernels_phase(data, queries, cfg, flush) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from repro_torch.core import hashing, pipeline
    from repro_torch.kernels.hash_pack import ops as hp, ref as hp_ref
    from repro_torch.kernels.l1_topk import ops as l1, ref as l1_ref
    from repro_torch.kernels.query_fused import ops as qf, ref as qf_ref

    n_loc = data.shape[0] // NU
    cell = data[:n_loc].contiguous()  # node 0's slice: one cell's points
    outer, inner = pipeline.make_family(torch.Generator().manual_seed(SEED), data.shape[1], cfg, data.device)
    l_loc = cfg.L_out // P
    outer0 = hashing.BitSampleParams(outer.dims[:l_loc], outer.thrs[:l_loc], outer.salts[:l_loc])
    rows = []

    # A: bitsample_pack, words + margins, on every point of one cell
    dims, thrs = hp.bitsample_columns(outer0)
    t, d, m_cols = cell.shape[0], cell.shape[1], dims.shape[0]
    wk, mk = hp.bitsample_pack(cell, dims, thrs, margins=True)
    wr, mr = hp_ref.bitsample_pack_ref(cell, dims, thrs, margins=True)
    need(torch.equal(wk, wr) and torch.equal(mk, mr), "bitsample_pack differs from its plain version")
    b_ms, b_by = bound(t * d * 4 + m_cols * 8 + t * m_cols // 8 + t * m_cols * 4, 3 * t * m_cols)
    rows.append(dict(
        name="bitsample_pack", route="cuda", source="src/repro_torch/csrc/hash_pack.cu",
        replaces="src/repro/kernels/hash_pack/hash_pack.py:112",
        also_replaces="src/repro/kernels/hash_pack/hash_pack.py:139",
        shape=f"x ({t}, {d}), {m_cols} columns, margins", exact=True,
        max_abs_err=float((mk - mr)[torch.isfinite(mr)].abs().max()),  # padded columns hold inf
        ms=timed_ms(lambda: hp.bitsample_pack(cell, dims, thrs, margins=True), 50, flush),
        plain_ms=timed_ms(lambda: hp_ref.bitsample_pack_ref(cell, dims, thrs, margins=True), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))

    # B: proj_sign_pack on the inner family, every point of one cell; the
    # plain version is a full-float32 matmul (TF32 off)
    n_tab, _, m_in = inner.proj.shape
    m_pad = 32 * -(-m_in // 32)
    proj = torch.nn.functional.pad(inner.proj, (0, m_pad - m_in)).permute(1, 0, 2)
    cols = proj.reshape(d, n_tab * m_pad).contiguous()
    bias = torch.zeros(n_tab * m_pad, device=data.device)
    wk, mk = hp.proj_sign_pack(cell, cols, bias, m_in, m_pad, margins=True)
    wr, mr = hp_ref.proj_sign_pack_ref(cell, cols, bias, m_in, m_pad, margins=True)
    need(torch.equal(hp.proj_sign_pack(cell, cols, bias, m_in, m_pad), wk), "proj_sign_pack words depend on the margins mode")
    real = (torch.arange(cols.shape[1], device=data.device) % m_pad) < m_in
    margin_err = float((mk - mr)[:, real].abs().max())
    s = cell @ cols
    bits_k = (wk[:, :, None] >> torch.arange(32, device=data.device)) & 1
    bits_r = (wr[:, :, None] >> torch.arange(32, device=data.device)) & 1
    diff = (bits_k != bits_r).reshape(t, -1)
    scale = 1e-5 * cell.norm(dim=1, keepdim=True) * cols.norm(dim=0, keepdim=True)
    need(not bool((diff & (s.abs() > scale)).any()), "proj_sign_pack flips a bit far from zero")
    # margins mode on a one-hot projection must reproduce kernel A
    ow, om = hp.onehot_pack_margins(cell, outer0.dims, outer0.thrs)
    aw, am = hp.probe_words(outer0, cell)
    ties = am == 0  # x[dim] == thr: A's bit is 0 (>), B's is 1 (>=)
    tie_words = ties.reshape(t, l_loc, -1, 32).any(dim=-1)
    need(torch.equal(om, am), "one-hot proj_sign_pack margins differ from bitsample_pack")
    need(torch.equal(ow[~tie_words], aw[~tie_words]), "one-hot proj_sign_pack words differ from bitsample_pack")
    # the words-only launch: x read once, P and bias once, one word per 32
    # columns; the function needs 2*d flops for each of the L_in*m_in real
    # columns (padded columns pack a 0 bit whatever s is)
    b_ms, b_by = bound(
        t * d * 4 + cols.numel() * 4 + bias.numel() * 4 + t * cols.shape[1] // 8,
        2 * t * d * n_tab * m_in,
    )
    # the margins launch (#4) also writes t * cols f32 margins
    bm_ms, bm_by = bound(
        t * d * 4 + cols.numel() * 4 + bias.numel() * 4 + t * cols.shape[1] // 8 + t * cols.shape[1] * 4,
        2 * t * d * n_tab * m_in,
    )
    rows.append(dict(
        name="proj_sign_pack", route="cuda", source="src/repro_torch/csrc/hash_pack.cu",
        replaces="src/repro/kernels/hash_pack/hash_pack.py:210",
        also_replaces="src/repro/kernels/hash_pack/hash_pack.py:175",
        shape=f"x ({t}, {d}), proj ({d}, {cols.shape[1]}), {n_tab * m_in} real columns",
        exact=bool(not diff.any()), disagreeing_bits=int(diff.sum()),
        max_abs_err=margin_err, max_abs_err_of="margins |s| against the float32 matmul",
        onehot_vs_bitsample=dict(margins_equal=True, words_equal_off_ties=True, tie_columns=int(ties.sum())),
        ms=timed_ms(lambda: hp.proj_sign_pack(cell, cols, bias, m_in, m_pad), 50, flush),
        plain_ms=timed_ms(lambda: hp_ref.proj_sign_pack_ref(cell, cols, bias, m_in, m_pad), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        margins_replaces="src/repro/kernels/hash_pack/hash_pack.py:175",
        margins_ms=timed_ms(lambda: hp.proj_sign_pack(cell, cols, bias, m_in, m_pad, margins=True), 50, flush),
        margins_plain_ms=timed_ms(
            lambda: hp_ref.proj_sign_pack_ref(cell, cols, bias, m_in, m_pad, margins=True), 10, flush),
        margins_bound_ms=bm_ms, margins_bound_by=bm_by, margins_library_ms=None,
    ))

    # the main path's candidates for one 50-query chunk of cell (0, 0),
    # from a plain-backend build of that cell
    cfg_t = cfg.replace(backend="torch")
    index = pipeline.build_from_params(cell, outer0, inner, cfg_t)
    qs = queries[: cfg.query_chunk].contiguous()
    backend = pipeline.get_backend("torch")
    pk, ik = pipeline._stage_hash(index, qs, cfg_t, backend)
    cand, _ = pipeline._stage_gather_fast(index, cfg_t, pk, ik)
    cand = cand.contiguous()
    run, c_w = pipeline._fused_run(cfg), cand.shape[1]
    cc = pipeline._compact_width(cfg, c_w, n_loc)
    cs, uniq, comparisons = pipeline._stage_dedup(cand)
    comp, valid, _ = pipeline._stage_compact(cs, uniq, comparisons, cc)
    q_n, k = qs.shape[0], cfg.k

    # C: l1_topk on the compacted (Q, c_comp, d) block
    pts = cell[comp.long().clamp(0, n_loc - 1)].contiguous()
    valid = valid.contiguous()
    dk, pk_ = l1.l1_topk(qs, pts, valid, k)
    dr, pr = l1_ref.l1_topk_ref(qs, pts, valid, k)
    need_topk(dk, pk_, dr, pr, lambda rows, pos: (pts[rows, pos.long()] - qs[rows]).abs().sum(-1),
              "l1_topk differs from its plain version")
    n_valid = int(valid.sum())
    b_ms, b_by = bound(n_valid * d * 4 + valid.numel() + q_n * d * 4 + q_n * k * 8, 3 * n_valid * d)
    rows.append(dict(
        name="l1_topk", route="cuda", source="src/repro_torch/csrc/l1_topk.cu",
        replaces="src/repro/kernels/l1_topk/l1_topk.py:100",
        shape=f"cands ({q_n}, {cc}, {d}), {n_valid} valid", exact=bool(torch.equal(pk_, pr)),
        max_abs_err=float((dk - dr).abs().nan_to_num(0.0).max()),
        ms=timed_ms(lambda: l1.l1_topk(qs, pts, valid, k), 50, flush),
        plain_ms=timed_ms(lambda: l1_ref.l1_topk_ref(qs, pts, valid, k), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))

    # D: the fused tail on the chunk's raw (Q, C) candidate rows
    out_k = qf.query_tail(cell, qs, cand, run=run, c_comp=cc, k=k)
    out_r = qf_ref.query_tail_ref(cell, qs, cand, c_comp=cc, k=k)
    need(torch.equal(out_k[2], out_r[2]) and torch.equal(out_k[3], out_r[3]), "query_tail counters differ")
    need_topk(out_k[0], out_k[1], out_r[0], out_r[1], point_dist_of(cell, qs), "query_tail top-k differs")
    gathered = int(out_r[2].clamp(max=cc).sum())
    c_pad = qf._run_padded_width(c_w, run)  # run is a power of two here
    merge_cx = q_n * merge_exchanges(c_pad, run)
    b_ms, b_by = bound(
        cand.numel() * 4 + q_n * d * 4 + gathered * d * 4 + q_n * (k * 8 + 8),
        3 * gathered * d + merge_cx,
    )
    rows.append(dict(
        name="query_tail", route="cuda", source="src/repro_torch/csrc/query_fused.cu",
        replaces="src/repro/kernels/query_fused/query_fused.py:496",
        also_replaces="src/repro/kernels/query_fused/query_fused.py:467",
        shape=f"cand ({q_n}, {c_w}), run {run}, c_comp {cc}, k {k}, {gathered} rows gathered",
        exact=bool(torch.equal(out_k[1], out_r[1])),
        max_abs_err=float((out_k[0] - out_r[0]).abs().nan_to_num(0.0).max()),
        ms=timed_ms(lambda: qf.query_tail(cell, qs, cand, run=run, c_comp=cc, k=k), 50, flush),
        plain_ms=timed_ms(lambda: qf_ref.query_tail_ref(cell, qs, cand, c_comp=cc, k=k), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del index, cand, pts
    rows += payload_kernel_rows(data, queries, cfg, (outer, inner), flush)
    return rows


def merge_exchanges(c_pad: int, run: int) -> int:
    """Compare-exchanges of one row's merge network from the run width up
    (a full bitonic sort when ``run`` is 1): log2(size) steps of
    ``c_pad / 2`` for each merge level."""
    sizes = [run << e for e in range(1, (c_pad // run).bit_length())]
    return (c_pad // 2) * sum(s_.bit_length() - 1 for s_ in sizes)


def payload_kernel_rows(data, queries, cfg, family, flush) -> list[dict]:
    """Kernel E, per payload format, against its plain version on the first
    50-query chunk of a plain-backend single shard over every point."""
    import torch

    from repro_torch.core import pipeline
    from repro_torch.kernels.blocking import next_pow2
    from repro_torch.kernels.query_fused import ops as qf, ref as qf_ref
    from repro_torch.runtime import payload as payload_mod

    n, d = data.shape
    cfg_t = cfg.replace(backend="torch", c_rerank=C_RERANK)
    index = pipeline.build_from_params(data, *family, cfg_t)
    qs = queries[: cfg.query_chunk].contiguous()
    pk, ik = pipeline._stage_hash(index, qs, cfg_t, pipeline.get_backend("torch"))
    cand, _ = pipeline._stage_gather_fast(index, cfg_t, pk, ik)
    del index
    cand = cand.contiguous()
    run, c_w, k = pipeline._fused_run(cfg), cand.shape[1], cfg.k
    cc = pipeline._compact_width(cfg, c_w, n)
    q_n = qs.shape[0]
    out_d = qf.query_tail(data, qs, cand, run=run, c_comp=cc, k=k)  # kernel D on the same rows
    rows = []
    for fmt in ("f16", "i8"):
        pl = payload_mod.make_payload(data, fmt)
        args = (data, pl.qdata, pl.meta, qs, cand)
        kw = dict(c_comp=cc, c_rerank=C_RERANK, k=k)
        out_k = qf.query_tail_payload(*args, run=run, **kw)
        out_r = qf_ref.query_tail_payload_ref(*args, **kw)
        for i, what in ((2, "comparisons"), (3, "overflow"), (4, "rerank_misses")):
            need(torch.equal(out_k[i], out_r[i]), f"query_tail_payload ({fmt}) {what} differ from its plain version")
        exact = bool(torch.equal(out_k[0], out_r[0]) and torch.equal(out_k[1], out_r[1]))
        if not exact:
            need_topk(out_k[0], out_k[1], out_r[0], out_r[1], point_dist_of(data, qs),
                      f"query_tail_payload ({fmt}) top-k differs")
        # the certificate at kernel level: a row with no miss equals kernel D's bit for bit
        ok = out_k[4] == 0
        need(torch.equal(out_k[0][ok], out_d[0][ok]) and torch.equal(out_k[1][ok], out_d[1][ok]),
             f"query_tail_payload ({fmt}) rows with no miss differ from query_tail")
        gathered = int(out_r[2].clamp(max=cc).sum())
        shortlisted = int(out_r[2].clamp(max=min(C_RERANK, cc)).sum())
        c_pad = qf._run_padded_width(c_w, run)
        cx = q_n * (merge_exchanges(c_pad, run) + merge_exchanges(next_pow2(cc), 1))
        itemsize = payload_mod.payload_itemsize(fmt)
        b_ms, b_by = bound(
            cand.numel() * 4 + q_n * d * 4 + gathered * (d * itemsize + 8) + shortlisted * d * 4
            + q_n * (k * 8 + 12),
            3 * d * (gathered + shortlisted) + cx,
        )
        rows.append(dict(
            name=f"query_tail_payload.{fmt}", kernel="query_tail_payload", route="cuda",
            source="src/repro_torch/csrc/query_payload.cu",
            replaces="src/repro/kernels/query_fused/query_fused.py:592",
            also_replaces="src/repro/kernels/query_fused/query_fused.py:564",
            shape=(f"cand ({q_n}, {c_w}), run {run}, c_comp {cc}, c_rerank {C_RERANK}, k {k}, {fmt} rows,"
                   f" {gathered} rows gathered, {shortlisted} reranked"),
            exact=exact, rerank_misses=int(out_k[4].sum()), zero_miss_rows_equal_to_query_tail=int(ok.sum()),
            max_abs_err=float((out_k[0] - out_r[0]).abs().nan_to_num(0.0).max()),
            ms=timed_ms(lambda: qf.query_tail_payload(*args, run=run, **kw), 50, flush),
            plain_ms=timed_ms(lambda: qf_ref.query_tail_payload_ref(*args, **kw), 10, flush),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ))
        del pl, args
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    run(torch.device("cuda"), N, NQ)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev, n: int, nq: int) -> None:
    """Every phase after the device check, on ``dev`` at ``n`` points and
    ``nq`` queries; prints the kernels line last."""
    import torch

    from repro_torch import dslsh
    from repro_torch.core import distributed as D
    from repro_torch.core import pipeline, predict
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = _build.build()
    emit("build", seconds=time.perf_counter() - t0, libraries=[p.name for p in libs.values()])

    t0 = time.perf_counter()
    pts, labs, qx, qy = synth(n, nq)
    data = torch.as_tensor(pts, device=dev)
    queries = torch.as_tensor(qx, device=dev)
    emit("data", n=n, queries=nq, seconds=time.perf_counter() - t0)

    cfg = dslsh.make_config(**CFG, backend="cuda")
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    rows = kernels_phase(data, queries, cfg, lambda: scratch.zero_())
    del scratch
    emit("kernels_checked", kernels=[r["name"] for r in rows])

    # main path: build + query through the user's entry points
    deploy = dslsh.grid(nu=NU, p=P)
    sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    index = dslsh.build(SEED, pts, cfg, deploy, dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = index.query(qx)
    sync(dev)
    query_s = time.perf_counter() - t0
    main_launches = dict(_build.LAUNCHES)
    for name in ("bitsample_pack", "proj_sign_pack", "query_tail"):
        need(main_launches.get(name, 0) > 0, f"main path never launched {name}")
    need(res.knn_idx.shape == (nq, cfg.k) and res.knn_dist.shape == (nq, cfg.k), "result shape")
    found = res.knn_idx >= 0
    need(bool(torch.isfinite(res.knn_dist[found]).all()) and bool((res.knn_idx < n).all()), "result values")
    labels = torch.as_tensor(labs, device=dev)
    truth = torch.as_tensor(qy, device=dev)
    mcc = float(predict.mcc(predict.predict_batch(labels, res.knn_idx, res.knn_dist), truth))
    t0 = time.perf_counter()
    pkd, pki, pcomps = dslsh.pknn_query(data, queries, cfg.k, deploy.grid)
    sync(dev)
    pknn_s = time.perf_counter() - t0
    mcc_p = float(predict.mcc(predict.predict_batch(labels, pki, pkd), truth))
    med = float(res.max_comparisons_per_cell.to(torch.float32).median())
    per_proc = int(pcomps[0, 0, 0])
    emit(
        "main_path", n=n, queries=nq, grid=[NU, P], backend="cuda",
        build_s=build_s, query_s=query_s, us_per_query=query_s / nq * 1e6,
        median_max_comparisons_per_cell=med, pknn_comparisons_per_processor=per_proc,
        speedup=per_proc / max(med, 1.0), mcc_dslsh=mcc, mcc_pknn=mcc_p,
        pknn_s=pknn_s, overflow_cells=res.overflow_cells, launches=main_launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None,
    )
    need(mcc >= mcc_p - 0.1, f"DSLSH MCC {mcc} below PKNN's {mcc_p} by more than 0.1")

    # where the query time goes: a profiled grid query of 200 queries
    # (40 cells x 4 chunks)
    emit("query_profile", **profile_query(dev, lambda: index.query(qx[:200])))

    # multiprobe: the words+margins launch on the query path
    n_mp = min(131_072, n)
    cfg_mp = cfg.replace(multiprobe=2)
    nq_mp = 500
    single = dslsh.build(SEED, pts[:n_mp], cfg_mp, dslsh.single(), dev)
    sync(dev)
    _build.reset_launches()  # count the query's launches only
    res_mp = single.query(qx[:nq_mp])
    sync(dev)
    mp_launches = dict(_build.LAUNCHES)
    ref_mp = pipeline.query_batch(
        single.pipeline_index, single._state["data"], queries[:nq_mp], cfg_mp.replace(backend="torch")
    )
    chunks = -(-nq_mp // cfg_mp.query_chunk)
    need(mp_launches.get("bitsample_pack.margins", 0) == chunks,
         f"multiprobe query made {mp_launches.get('bitsample_pack.margins', 0)} words+margins launches, not one per chunk ({chunks})")
    need(torch.equal(res_mp.comparisons[0, 0], ref_mp.comparisons), "multiprobe comparisons differ")
    need_topk(res_mp.knn_dist, res_mp.knn_idx, ref_mp.knn_dist, ref_mp.knn_idx,
              point_dist_of(single._state["data"], queries), "multiprobe top-k differs")
    emit("multiprobe", n=n_mp, queries=nq_mp, query_launches=mp_launches,
         mean_comparisons=float(res_mp.comparisons.to(torch.float32).mean()))

    # backends agree on the card: the plain path on the same grid index
    nq_b = 256
    ref = D.grid_query(
        index.pipeline_index, index._state["data"], queries[:nq_b],
        cfg.replace(backend="torch"), deploy.grid,
    )
    need(torch.equal(ref.comparisons, res.comparisons[:, :, :nq_b]), "torch/cuda comparisons differ")
    need(torch.equal(ref.compaction_overflow, res.compaction_overflow[:, :, :nq_b]), "torch/cuda overflow differs")
    need_topk(res.knn_dist[:nq_b], res.knn_idx[:nq_b], ref.knn_dist, ref.knn_idx,
              point_dist_of(index._state["data"], queries), "torch/cuda top-k differs")
    emit("backends_agree", queries=nq_b, knn_idx_identical=bool(torch.equal(ref.knn_idx, res.knn_idx[:nq_b])),
         max_abs_dist_err=float((ref.knn_dist - res.knn_dist[:nq_b]).abs().nan_to_num(0.0).max()))

    del index, res, ref
    payload_launches = payload_phase(dev, pts, qx, labels, truth, cfg, mcc_p)

    for r in rows:
        if r.get("kernel") == "query_tail_payload":  # runs on the payload path only
            r["launches"] = payload_launches.get(r["name"], 0)
        else:
            r["launches"] = main_launches.get(r["name"], 0)
            r["multiprobe_query_launches"] = mp_launches.get(r["name"], 0)
        r["payload_query_launches"] = payload_launches.get(r["name"], 0)
    print(json.dumps({"kernels": rows}), flush=True)


def payload_phase(dev, pts, qx, labels, truth, cfg, mcc_pknn: float) -> dict:
    """The compressed-payload path on the user's entry points: one shard over
    every point, built and queried as f32, f16 and i8 in turn (each index
    freed before the next). A query with no rerank miss must equal the f32
    handle's answer bit for bit, and each compressed MCC may fall at most
    0.01 below the f32 shard's. Returns the payload tail's launches over
    both compressed queries."""
    import torch

    from repro_torch import dslsh
    from repro_torch.core import pipeline, predict
    from repro_torch.kernels import _build
    from repro_torch.runtime import payload as payload_mod

    n, nq = pts.shape[0], qx.shape[0]
    chunks = -(-nq // cfg.query_chunk)
    launches: dict[str, int] = {}
    f32 = None
    for fmt in ("f32", "f16", "i8"):
        cfg_p = cfg.replace(payload=fmt, c_rerank=C_RERANK)
        sync(dev)
        t0 = time.perf_counter()
        index = dslsh.build(SEED, pts, cfg_p, dslsh.single(), dev)
        index._payload()  # quantize once, as part of the build
        sync(dev)
        build_s = time.perf_counter() - t0
        _build.reset_launches()
        t0 = time.perf_counter()
        res = index.query(qx)
        sync(dev)
        query_s = time.perf_counter() - t0
        got = dict(_build.LAUNCHES)
        fused = "query_tail" if fmt == "f32" else f"query_tail_payload.{fmt}"
        need(got.get(fused, 0) == chunks, f"payload {fmt}: {got.get(fused, 0)} launches of {fused}, not one per chunk ({chunks})")
        need(res.knn_idx.shape == (nq, cfg.k) and bool((res.knn_idx < n).all()), f"payload {fmt}: result shape or values")
        found = res.knn_idx >= 0
        need(bool(torch.isfinite(res.knn_dist[found]).all()), f"payload {fmt}: non-finite distances")
        mcc = float(predict.mcc(predict.predict_batch(labels, res.knn_idx, res.knn_dist), truth))
        cc = pipeline._compact_width(cfg_p, cfg_p.L_out * cfg_p.slot, n)
        fields = dict(
            format=fmt, n=n, queries=nq, c_rerank=C_RERANK, c_comp=cc, build_s=build_s, query_s=query_s,
            us_per_query=query_s / nq * 1e6,
            median_comparisons=float(res.comparisons.to(torch.float32).median()),
            overflow_queries=int((res.compaction_overflow > 0).sum()),
            rerank_miss_total=res.rerank_miss_total,
            tail_gather_bytes_per_query=payload_mod.tail_gather_bytes(cc, C_RERANK, pts.shape[1], fmt),
            payload_bytes=index.memory_report().components["payload"],
            mcc=mcc, mcc_pknn=mcc_pknn, launches=got,
        )
        if fmt == "f32":
            need(res.rerank_misses is None, "the f32 shard reports rerank misses")
            f32 = (res.knn_idx, res.knn_dist, mcc)
        else:
            for name, c in got.items():
                if name.startswith("query_tail_payload"):
                    launches[name] = launches.get(name, 0) + c
            ok = res.rerank_misses[0, 0] == 0
            same = bool(torch.equal(res.knn_idx[ok], f32[0][ok]) and torch.equal(res.knn_dist[ok], f32[1][ok]))
            need(same, f"payload {fmt}: a query with no rerank miss differs from the f32 shard")
            need(mcc >= f32[2] - 0.01, f"payload {fmt}: MCC {mcc} more than 0.01 below the f32 shard's {f32[2]}")
            fields.update(
                certified_queries=int(ok.sum()), mcc_f32=f32[2],
                knn_idx_identical_to_f32=bool(torch.equal(res.knn_idx, f32[0])),
            )
        emit("payload", **fields)
        # where this query's time goes: a profiled 200-query window
        emit("payload_profile", format=fmt, **profile_query(dev, lambda: index.query(qx[:200])))
        del index, res
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return launches


if __name__ == "__main__":
    sys.exit(main())
