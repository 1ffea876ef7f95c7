"""Find the knee of an open-loop serving cell: the highest offered rate
(windows/s) at which the queue does not grow over a window.

    python3 bench/sweep.py --workload grid40-icu-open --seed <n> --seconds 20 --rates 150 200 250 300

Builds the cell's index and front end once, then offers each rate for
``--seconds`` with the cell's traffic mix and prints one JSON line a rate:
the rows served a second, the latency's median and 95th percentile, the
queued rows over the first and second half of the window, how long the
queue took to drain after the last arrival, and the pumps by the ladder
rung their rows padded to, with each rung's median pump time. Run once to
set a cell's ``rate_windows_per_s``; the benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from bench import harness, inputs, program  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    from repro_torch.serve.frontend import FrontendConfig, ServeFrontend

    harness.use_checkout_caches(ROOT)
    dev = torch.device("cuda", 0)
    r = harness.Run(ROOT, args.workload, args.seed, args.seconds, False, dev, time.perf_counter())
    serve = harness.load_module(ROOT / "bench" / "drivers" / f"{r.traffic['driver']}.py", "bench_sweep_driver")
    inp = program.seeded_inputs(r, int(r.traffic["pool"]))
    pool_np = inp["pool"].cpu().numpy()
    index = program.build_grid(r, inp)
    fe = ServeFrontend(index, FrontendConfig(ladder=tuple(r.traffic["ladder"])))
    fe.warmup()
    print(json.dumps({"card": torch.cuda.get_device_name(dev)}), flush=True)
    for rate in args.rates:
        tr = dict(r.traffic, rate_windows_per_s=rate)
        reqs = serve.arrivals(tr, args.seconds, args.seed, f"sweep{rate}")
        gen = inputs.rng(args.seed, f"sweep{rate}.rows")
        rows = [gen.integers(0, pool_np.shape[0], size=k) for _, _, k in reqs]
        log = {"lag_s": [], "latency_s": [], "pump_s": [], "answered": [], "unanswered": 0, "depth": []}
        t0 = time.perf_counter()
        serve.serve(fe, reqs, pool_np, rows, log)
        wall = time.perf_counter() - t0
        half = [d for t, d, _, _ in log["depth"] if t < args.seconds / 2]
        late = [d for t, d, _, _ in log["depth"] if args.seconds / 2 <= t < args.seconds]
        rungs: dict = {}
        for _, _, n, ps in log["depth"]:
            if n:
                rungs.setdefault(min(x for x in fe.coalescer.ladder if x >= n), []).append(ps)
        lat = sorted(log["latency_s"])
        print(json.dumps({
            "rate_windows_per_s": rate, "requests": len(reqs), "windows": int(sum(k for _, _, k in reqs)),
            "served_windows_per_s": sum(k for _, _, k in reqs) / wall,
            "drain_s": wall - args.seconds, "latency_p50_ms": 1e3 * statistics.median(lat),
            "latency_p95_ms": 1e3 * harness.percentile(lat, 95), "pumps": len(log["pump_s"]),
            "pump_ms_median": 1e3 * statistics.median(log["pump_s"]),
            "queued_rows_first_half": statistics.mean(half) if half else 0.0,
            "queued_rows_second_half": statistics.mean(late) if late else 0.0,
            "shed": sum(1 for x in lat if x == float("inf")),
            "pumps_by_rung": {str(k): len(v) for k, v in sorted(rungs.items())},
            "pump_ms_by_rung": {str(k): 1e3 * statistics.median(v) for k, v in sorted(rungs.items())},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
