"""Open loop into ``ServeFrontend`` over the grid ``Index``: requests arrive
at fixed due times, are submitted once due, and a ``pump`` runs whenever the
queue holds any.

Traffic keys: ``rate_windows_per_s`` offered; ``tenants`` (name, share of
requests, least and most windows, uniform); ``ladder``; ``pool`` held-out
windows the requests draw their windows from; ``base_seed``, from which the
set of request sizes and arrival gaps is drawn once, so that every seed
offers the same work in its own order (the gaps of a Poisson process,
scaled to span the window exactly); ``profile_seconds`` of further arrivals
traced, and the first ``host_requests`` of a further plan traced with the
host's activity. Deadlines
are infinite: no answer is degraded and none fails for lateness, and a
shed request counts as failed. A request's latency runs from when it was
due to when its rows came back.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench import check, inputs, program, trace
from bench.reference import deploy as ref_deploy
from bench.reference import dslsh as ref_dslsh



def arrivals(tr: dict, seconds: float, seed: int, purpose: str) -> list[tuple[float, str, int]]:
    """(due offset s, tenant, windows) of each request: a fixed set of sizes
    and gaps for the traffic and the window's length, ordered by the seed."""
    names = [t["name"] for t in tr["tenants"]]
    share = np.asarray([t["share"] for t in tr["tenants"]], np.float64)
    mean_windows = float(sum(t["share"] * (t["windows"][0] + t["windows"][1]) / 2 for t in tr["tenants"]))
    n = max(1, int(round(tr["rate_windows_per_s"] * seconds / mean_windows)))
    rng = np.random.default_rng(int(tr["base_seed"]))
    which = rng.choice(len(names), size=n, p=share / share.sum())
    sizes = np.asarray([rng.integers(tr["tenants"][w]["windows"][0], tr["tenants"][w]["windows"][1] + 1)
                        for w in which])
    gaps = rng.exponential(1.0, size=n)
    gaps *= seconds / gaps.sum()
    order = inputs.shuffled(np.arange(n), seed, purpose + ".requests")
    gaps = inputs.shuffled(gaps, seed, purpose + ".gaps")
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [(float(due[i]), names[which[order[i]]], int(sizes[order[i]])) for i in range(n)]


def serve(fe, reqs: list, pool_np: np.ndarray, rows: list, log: dict) -> None:
    """Offer ``reqs`` from now on, pumping whenever requests are queued, until
    every one is answered or shed; records each request's latency and each
    pump's time in ``log``."""
    t0 = time.perf_counter()
    i, live = 0, {}
    while i < len(reqs) or fe.queue_depth:
        now = time.perf_counter()
        while i < len(reqs) and t0 + reqs[i][0] <= now:
            due, tenant, k = reqs[i]
            req = fe.submit(pool_np[rows[i]], tenant=tenant, deadline_s=math.inf)
            log["lag_s"].append(time.perf_counter() - (t0 + due))
            if req.status == "shed":
                log["latency_s"].append(math.inf)
            else:
                live[req.rid] = (t0 + due, i, req)
            i += 1
        if fe.queue_depth:
            tp = time.perf_counter()
            done = fe.pump()
            t_done = time.perf_counter()
            log["pump_s"].append(t_done - tp)
            if "depth" in log:  # (time, queued rows, rows served, pump s) of each pump, for the knee sweep
                log["depth"].append((t_done - t0, fe.queue_depth, sum(q.queries.shape[0] for q in done),
                                     t_done - tp))
            for req in done:
                due_at, j, _ = live.pop(req.rid)
                log["latency_s"].append(t_done - due_at)
                log["answered"].append((j, req))
        elif i < len(reqs):
            time.sleep(max(0.0, min(t0 + reqs[i][0] - time.perf_counter(), 0.01)))
    log["unanswered"] += len(live)


def run(r) -> None:
    from repro_torch import obs
    from repro_torch.serve.frontend import FrontendConfig, ServeFrontend

    tr, cfgf = r.traffic, r.config
    inp = program.seeded_inputs(r, int(tr["pool"]))
    pool = inp["pool"]
    pool_np = pool.cpu().numpy()
    index = program.build_grid(r, inp)
    bundle = obs.Obs(trace=False) if r.trace else None
    fe = ServeFrontend(index, FrontendConfig(ladder=tuple(tr["ladder"])), obs=bundle)
    fe.warmup()

    def plan(seconds: float, purpose: str):
        reqs = arrivals(tr, seconds, r.seed, purpose)
        gen = inputs.rng(r.seed, purpose + ".rows")
        return reqs, [gen.integers(0, pool_np.shape[0], size=k) for _, _, k in reqs]

    reqs, rows = plan(r.seconds, "window")
    log = {"lag_s": [], "latency_s": [], "pump_s": [], "answered": [], "unanswered": 0}
    r.setup_done()
    serve(fe, reqs, pool_np, rows, log)
    r.window_done()
    r.attempted = len(reqs)
    r.failed = sum(1 for x in log["latency_s"] if math.isinf(x)) + log["unanswered"]
    r.record.update(latency_s=log["latency_s"], pump_s=log["pump_s"], lag_s=log["lag_s"])

    if r.trace:
        snap = bundle.metrics.snapshot()
        r.record["served_rows"] = _counter(snap, "dslsh_serve_queries_served_total")
        r.record["pad_rows"] = _counter(snap, "dslsh_serve_pad_rows_total")
        p_reqs, p_rows = plan(float(tr["profile_seconds"]), "profile")
        scratch = {"lag_s": [], "latency_s": [], "pump_s": [], "answered": [], "unanswered": 0}
        r.record["profile"] = trace.device_slice(lambda: serve(fe, p_reqs, pool_np, p_rows, scratch))
        h_reqs, h_rows = plan(float(tr["profile_seconds"]), "host")
        h_reqs = h_reqs[: int(tr["host_requests"])]
        r.breakdown = {"device_ops": trace.top_ops(r.record["profile"]),
                       "idle_gaps": trace.idle_gaps(lambda: serve(fe, h_reqs, pool_np, h_rows, dict(scratch)))}

    torch.cuda.empty_cache()
    dep = cfgf["deployment"]
    off = program.TablesOff(index)
    ref, _ = ref_deploy.grid_answer(inp["data"], inp["outer"], inp["inner"], cfgf["slsh"], dep["nu"], dep["p"],
                                    pool, on_cell=off)
    gap, unmatched = 0.0, 0
    for j, req in log["answered"]:
        sel = torch.as_tensor(rows[j], device=pool.device)
        got = check.knn_numbers(torch.as_tensor(req.knn_dist), torch.as_tensor(req.knn_idx),
                                ref_dslsh.Answer(ref.dist[sel], ref.idx[sel]), check.l1_of(inp["data"], pool[sel]))
        gap = max(gap, got["dist_gap"])
        unmatched += got["idx_unmatched"]
    r.numbers.update(dist_gap=gap, idx_unmatched=unmatched, tables_off=off.total,
                     unanswered=log["unanswered"] + sum(1 for _, q in log["answered"] if q.status != "done"))


def _counter(snap: dict, name: str) -> float:
    fam = snap.get(name)
    return float(sum(fam["values"].values())) if fam else 0.0
