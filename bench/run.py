"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: makes the inputs from ``--seed``, builds and
warms the program (``repro_torch``, from ``src/``), measures for
``--seconds`` seconds, judges what the measured path produced against the
plain reference in ``bench/reference``, and prints the judged numbers beside
their limits as the last lines of standard error and one JSON object as the
last line of standard output: the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``. Exits with another code than
0, printing no result, without a CUDA card (or with fewer than the cell
asks for), without the program, or where ``jax``, ``jaxlib``, ``flax``, the
JAX package ``repro`` or ``benchmarks`` was loaded.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness

    t_start = time.perf_counter() - harness.process_age_s()
    harness.use_checkout_caches(ROOT)
    import torch

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: int(w.get("chips", 1)) for w in manifest["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = harness.Run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start)
    out, lines = harness.run_cell(run)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that no run may load were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
