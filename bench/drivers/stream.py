"""Closed loop of ``StreamingMonitor.step`` ticks: each tick ``beds`` fresh
windows made from the seed, one per bed, predicted and then ingested with
their labels; the timestamp advances by 1 a tick.

Set-up warms the monitor on the configuration's windows, runs one tick a
node (every shape of a tick), then pre-fills the nodes' delta segments so
that their compactions fall spread over the window: ``delta_cap / beds``
rounds of one ingest a node, node ``j`` compacted where
``start_fill_batches[j]`` rounds are left, so it starts the window holding
that many batches. The live windows are drawn from the seed as they are
needed, ``live_block`` at a time, so a faster program only makes more
ticks. Traffic keys: ``beds``, ``start_fill_batches``, ``live_block``,
``check_ticks`` (ticks whose answers the reference checks, drawn from the
seed, and the last), ``profile_ticks`` (traced) and ``host_ticks`` (traced
with the host's activity).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import check, inputs, program, trace
from bench.reference import deploy as ref_deploy
from bench.reference import dslsh as ref_dslsh


def run(r) -> None:
    from repro_torch import params
    from repro_torch.core import distributed as D
    from repro_torch.stream import StreamingMonitor

    tr, cfgf = r.traffic, r.config
    dep, spec = cfgf["deployment"], cfgf["windows"]
    beds, nu, p = int(tr["beds"]), dep["nu"], dep["p"]
    rounds = dep["delta_cap"] // beds
    fill = [int(x) for x in tr["start_fill_batches"]]
    if len(fill) != nu or not all(1 <= x <= rounds for x in fill):
        raise ValueError(f"start_fill_batches needs {nu} entries in [1, {rounds}]")
    block = int(tr["live_block"])
    if block % beds:
        raise ValueError(f"live_block {block} is not a whole number of ticks of {beds}")
    inp = program.seeded_inputs(r, 0)
    live = inputs.LiveWindows(spec, r.seed, block, r.device)
    cfg = program.slsh_config(cfgf)
    mon = StreamingMonitor(
        params.from_jax_params(inp["outer"], inp["inner"], r.device),
        inp["data"].cpu().numpy(), inp["labels"].cpu().numpy(), cfg, D.Grid(nu=nu, p=p),
        node_capacity=dep["node_capacity"], delta_cap=dep["delta_cap"], route=dep.get("routed", True),
        device=r.device,
    )
    captured = []  # the answer of every tick's prediction, as the program gave it
    query = mon.core.query

    def recording_query(qs):
        res = query(qs)
        captured.append(res)
        return res

    mon.core.query = recording_query
    ops: list[tuple] = []  # what was done, in order, for the reference to replay
    cursor = [0]

    def take() -> tuple[int, int]:
        lo = cursor[0]
        cursor[0] = lo + beds
        return lo, lo + beds

    events = []

    def tick() -> float:
        lo, hi = take()
        xs, _, ys_np = live(lo, hi)
        t0 = time.perf_counter()
        ev = mon.step(xs, ys_np, float(len(ops) + 1))
        r.sync()
        dt = time.perf_counter() - t0
        ops.append(("tick", lo, hi))
        events.append(ev)
        return dt

    for _ in range(nu):  # one tick a node: every shape of a tick
        tick()
    for rnd in range(rounds):
        for j in range(nu):
            if rnd == rounds - fill[j]:
                mon.core.maintain(j, float(len(ops) + 1))
                ops.append(("compact", j))
            lo, hi = take()
            xs, _, ys_np = live(lo, hi)
            mon.ingest(xs, ys_np, float(len(ops) + 1))
            ops.append(("ingest", lo, hi))
    r.setup_done()

    first = len(events)
    ticks = []
    t_window = time.perf_counter()
    while time.perf_counter() - t_window < r.seconds:
        dt = tick()
        ev = events[-1]
        ticks.append((dt, ev.latency_s, beds, ev.compacted))
    r.window_done()
    window_events = events[first:]
    r.attempted = beds * len(window_events)
    r.failed = sum(ev.dropped for ev in window_events)
    r.record.update(ticks=ticks)

    if r.trace:
        n = int(tr["profile_ticks"])
        r.record["profile"] = trace.device_slice(lambda: [tick() for _ in range(n)])
        r.breakdown = {"device_ops": trace.top_ops(r.record["profile"]),
                       "idle_gaps": trace.idle_gaps(lambda: [tick() for _ in range(int(tr["host_ticks"]))])}

    # the reference replays every operation and answers the checked ticks
    torch.cuda.empty_cache()
    tick_of = {i: t for t, i in enumerate(i for i, op in enumerate(ops) if op[0] == "tick")}
    window_ticks = list(range(first, first + len(window_events)))
    checked = set(inputs.shuffled(np.asarray(window_ticks), r.seed, "check_ticks")[: int(tr["check_ticks"])].tolist())
    checked.add(window_ticks[-1])
    state = ref_deploy.StreamState(inp["data"], inp["labels"], nu, p, dep["node_capacity"], dep["delta_cap"])
    cache: dict = {}
    slsh = cfgf["slsh"]
    gap, unmatched, comps_off, votes_off = 0.0, 0, 0, 0
    for i, op in enumerate(ops):
        if op[0] == "compact":
            state.compact(op[1])
            continue
        xs, ys, _ = live(op[1], op[2])
        t = tick_of.get(i)
        if t in checked:
            ref, ref_comps = ref_deploy.stream_answer(state, state.snapshot(), inp["outer"], inp["inner"],
                                                      slsh, xs, cache)
            res = captured[t]
            got = check.knn_numbers(res.knn_dist, res.knn_idx, ref, true_dist(state, xs))
            gap = max(gap, got["dist_gap"])
            unmatched += got["idx_unmatched"]
            comps_off += check.count_off(res.comparisons, ref_comps)
            want = ref_dslsh.vote(state.labels(), res.knn_idx.long(), res.knn_dist)
            votes_off += check.count_off(torch.as_tensor(events[t].preds), want)
        state.ingest(xs, ys)
    r.numbers.update(dist_gap=gap, idx_unmatched=unmatched, comparisons_off=comps_off,
                     votes_off=votes_off, tables_off=_final_tables_off(mon, state, inp, slsh, cache))


def true_dist(state, queries):
    """Float64 L1 distance of query rows to global rows of the streaming
    nodes (``node * node_capacity + row``)."""
    def dist(q_rows, idx):
        node, row = idx // state.capacity, idx % state.capacity
        out = torch.empty(idx.shape[0], dtype=torch.float64, device=idx.device)
        for j in node.unique().tolist():
            m = node == j
            a = state.rows(j)[row[m]].to(torch.float64)
            out[m] = (a - queries[q_rows[m]].to(torch.float64)).abs().sum(dim=-1)
        return out
    return dist


def _final_tables_off(mon, state, inp, slsh, cache) -> int:
    """Entries of every node's cells, and of their delta keys, that differ
    from the reference's state once the run is over."""
    off = 0
    snap = state.snapshot()
    for j, c, _, cell, delta in ref_deploy.stream_cells(state, snap, inp["outer"], inp["inner"], slsh, cache):
        node = mon.core.state[j]
        prog = node.cells[c]
        off += check.count_off(torch.tensor([node.n, node.count]), torch.tensor([snap[0][j], snap[1][j]]))
        off += check.cell_tables_off(prog.base, cell)
        off += check.count_off(prog.delta.outer_keys[: prog.delta.count], delta["outer"])
        off += check.count_off(prog.delta.inner_keys[: prog.delta.count], delta["inner"])
    return off
