"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the nearest precision below the
configuration's float32, bfloat16 (windows, queries, thresholds and
projections rounded to it), judged by the same numbers as a run.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...] [--ticks T]

Prints one JSON line a seed: the numbers the control reads. The benchmark's
own runs never run it; it sets the upper readings of the limits in
``bench/limits/``. A streaming cell's control replays the driver's set-up
and ``--ticks`` window ticks (about as many as a run makes).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench import check, harness, inputs, program  # noqa: E402
from bench.drivers.stream import true_dist  # noqa: E402
from bench.reference import deploy as ref_deploy  # noqa: E402
from bench.reference import dslsh as ref_dslsh  # noqa: E402


def lower(t: torch.Tensor) -> torch.Tensor:
    """A float tensor rounded to bfloat16 (other tensors as they are)."""
    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


def _low(inp: dict) -> dict:
    return {k: ({kk: lower(vv) for kk, vv in v.items()} if isinstance(v, dict) else lower(v)) for k, v in inp.items()}


def cells_off(a: ref_dslsh.Cell, b: ref_dslsh.Cell) -> int:
    """Entries of two reference cells that differ."""
    names = ("sorted_keys", "sorted_idx", "heavy_keys", "heavy_start", "heavy_size", "heavy_valid",
             "heavy_overflowed", "inner_keys", "inner_idx")
    return sum(check.count_off(getattr(a, f), getattr(b, f)) for f in names)


def grid_numbers(r) -> dict:
    """The control's numbers in a grid cell, over the whole pool."""
    inp = program.seeded_inputs(r, int(r.traffic["pool"]))
    low = _low(inp)
    dep, slsh = r.config["deployment"], r.config["slsh"]
    cells = {}
    ref, comps = ref_deploy.grid_answer(inp["data"], inp["outer"], inp["inner"], slsh, dep["nu"], dep["p"],
                                        inp["pool"], on_cell=lambda j, c, cell: cells.__setitem__((j, c), cell))
    off = [0]

    def on_low(j, c, cell):
        off[0] += cells_off(cell, cells.pop((j, c)))

    got, got_comps = ref_deploy.grid_answer(low["data"], low["outer"], low["inner"], slsh, dep["nu"], dep["p"],
                                            low["pool"], on_cell=on_low)
    out = check.knn_numbers(got.dist, got.idx, ref, check.l1_of(inp["data"], inp["pool"]))
    labels = inp["labels"].to(torch.int64)
    out.update(comparisons_off=check.count_off(got_comps, comps), tables_off=off[0],
               votes_off=check.count_off(ref_dslsh.vote(labels, got.idx, got.dist.to(torch.bfloat16).double()),
                                         ref_dslsh.vote(labels, got.idx, got.dist)))
    return out


def stream_numbers(r, ticks: int) -> dict:
    """The control's numbers in a streaming cell: the driver's operations
    replayed on two reference states, the checked ticks answered by both."""
    tr, dep, slsh = r.traffic, r.config["deployment"], r.config["slsh"]
    inp = program.seeded_inputs(r, 0)
    low = _low(inp)
    live = inputs.LiveWindows(r.config["windows"], r.seed, int(tr["live_block"]), r.device)
    nu, p, beds = dep["nu"], dep["p"], int(tr["beds"])
    rounds = dep["delta_cap"] // beds
    fill = [int(x) for x in tr["start_fill_batches"]]
    ops, cur = [], 0
    for _ in range(nu):
        ops.append(("tick", cur, cur + beds))
        cur += beds
    for rnd in range(rounds):
        for j in range(nu):
            if rnd == rounds - fill[j]:
                ops.append(("compact", j))
            ops.append(("ingest", cur, cur + beds))
            cur += beds
    first = nu
    for _ in range(ticks):
        ops.append(("tick", cur, cur + beds))
        cur += beds
    window = list(range(first, first + ticks))
    checked = set(inputs.shuffled(np.asarray(window), r.seed, "check_ticks")[: int(tr["check_ticks"])].tolist())
    checked.add(window[-1])
    states = [ref_deploy.StreamState(x["data"], x["labels"], nu, p, dep["node_capacity"], dep["delta_cap"])
              for x in (inp, low)]
    caches: list[dict] = [{}, {}]
    out = {"dist_gap": 0.0, "idx_unmatched": 0, "comparisons_off": 0, "votes_off": 0}
    t = -1
    for op in ops:
        if op[0] == "compact":
            for s in states:
                s.compact(op[1])
            continue
        if op[0] == "tick":
            t += 1
        xs, ys, _ = live(op[1], op[2])
        if op[0] == "tick" and t in checked:
            ans = [ref_deploy.stream_answer(s, s.snapshot(), x["outer"], x["inner"], slsh, q, c)
                   for s, x, q, c in zip(states, (inp, low), (xs, lower(xs)), caches)]
            (ref, comps), (got, got_comps) = ans
            nums = check.knn_numbers(got.dist, got.idx, ref, true_dist(states[0], xs))
            out["dist_gap"] = max(out["dist_gap"], nums["dist_gap"])
            out["idx_unmatched"] += nums["idx_unmatched"]
            out["comparisons_off"] += check.count_off(got_comps, comps)
        for s, q in zip(states, (xs, lower(xs))):
            s.ingest(q, ys)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--ticks", type=int, default=130)
    args = ap.parse_args()
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.Run(ROOT, args.workload, seed, 0.0, False, dev, t0)
        nums = stream_numbers(r, args.ticks) if r.traffic["driver"] == "stream" else grid_numbers(r)
        failed = sorted(k for k, v in nums.items() if k in r.limits and v > r.limits[k])
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "bfloat16", "numbers": nums,
                          "fails": failed, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
