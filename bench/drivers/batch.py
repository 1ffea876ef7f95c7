"""Closed loop, one client: whole ``Index.query`` calls on ``call_windows``
held-out windows each, then the AHE vote over their neighbours.

Traffic keys: ``pool`` held-out windows made from the seed, taken in turn
``call_windows`` at a time; ``profile_windows`` windows in the traced
slice and ``host_windows`` in the slice traced with the host's activity.
"""
from __future__ import annotations

import time

import torch

from bench import check, program, roofline, trace
from bench.reference import deploy as ref_deploy
from bench.reference import dslsh as ref_dslsh


def run(r) -> None:
    from repro_torch.core import predict

    tr, cfgf = r.traffic, r.config
    call = int(tr["call_windows"])
    inp = program.seeded_inputs(r, int(tr["pool"]))
    pool = inp["pool"]
    n_pool = pool.shape[0]
    blocks, rows = [], []
    lo = 0
    while True:  # the calls' query blocks, in turn over the pool
        idx = (torch.arange(call, device=pool.device) + lo) % n_pool
        blocks.append(pool[idx].contiguous())
        rows.append(idx)
        lo = (lo + call) % n_pool
        if lo == 0:
            break
    index = program.build_grid(r, inp)
    labels = inp["labels"]

    def one_call(q):
        res = index.query(q)
        return res, predict.predict_batch(labels, res.knn_idx, res.knn_dist)

    one_call(blocks[0][: 2 * cfgf["slsh"]["query_chunk"]])  # every shape of a call: its chunks are alike
    r.setup_done()

    calls, outs = [], []
    t_window = time.perf_counter()
    i = 0
    while time.perf_counter() - t_window < r.seconds:
        b = i % len(blocks)
        t0 = time.perf_counter()
        res, votes = one_call(blocks[b])
        r.sync()
        calls.append((call, time.perf_counter() - t0))
        outs.append((b, res, votes))
        i += 1
    r.window_done()
    r.attempted = call * len(calls)
    r.record.update(calls=calls, queries=r.attempted,
                    comparisons=sum(int(res.comparisons.sum()) for _, res, _ in outs))

    if r.trace:
        q = blocks[0][: int(tr["profile_windows"])]
        got = {}
        r.record["profile"] = trace.device_slice(lambda: got.update(res=index.query(q)))
        comps = got["res"].comparisons
        nbytes, ops = roofline.tail_work(int(comps.sum()), comps.numel(), cand_width(cfgf),
                                         cfgf["windows"]["d"], cfgf["slsh"]["k"])
        r.record["tail_bound_s"] = roofline.bound_s(nbytes, ops)
        r.record["profile_queries"] = q.shape[0]
        hq = blocks[0][: int(tr["host_windows"])]
        r.breakdown = {"device_ops": trace.top_ops(r.record["profile"]),
                       "idle_gaps": trace.idle_gaps(lambda: index.query(hq))}

    # the reference, once the window is over
    torch.cuda.empty_cache()
    dep = cfgf["deployment"]
    off = program.TablesOff(index)
    ref, ref_comps = ref_deploy.grid_answer(inp["data"], inp["outer"], inp["inner"], cfgf["slsh"], dep["nu"],
                                            dep["p"], pool, on_cell=off)
    gap, unmatched, comps_off, votes_off = 0.0, 0, 0, 0
    for b, res, votes in outs:
        sel = rows[b]
        sub = ref_dslsh.Answer(ref.dist[sel], ref.idx[sel])
        got = check.knn_numbers(res.knn_dist, res.knn_idx, sub, check.l1_of(inp["data"], blocks[b]))
        gap = max(gap, got["dist_gap"])
        unmatched += got["idx_unmatched"]
        comps_off += check.count_off(res.comparisons, ref_comps[:, :, sel])
        want = ref_dslsh.vote(labels.to(torch.int64), res.knn_idx.long(), res.knn_dist)
        votes_off += check.count_off(votes, want)
    r.numbers.update(dist_gap=gap, idx_unmatched=unmatched, comparisons_off=comps_off,
                     votes_off=votes_off, tables_off=off.total)


def cand_width(config: dict) -> int:
    """Candidate ids a (cell, query) pair hands kernel D: its tables times
    the per-table slot, ``max(c_max, L_in * c_in)``."""
    s = config["slsh"]
    return s["L_out"] // config["deployment"]["p"] * max(s["c_max"], s["L_in"] * s["c_in"])
