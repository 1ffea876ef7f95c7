"""Time the port's grid query on two checkouts of the repository, in pairs.

    python3 scripts/grid_query_pairs.py PARENT_ROOT CHANGE_ROOT [--pairs 3] [--repeats 3]

Each run is a fresh process that imports ``repro_torch`` from one root's
``src/``, builds that root's kernels, builds ``chip_smoke.py``'s main path (the
1.37 M-point ``grid(nu=10, p=4)`` on the ``"cuda"`` backend) and times
``index.query`` over its 2,000 queries ``--repeats`` times in a row, with
nothing else run before. Runs alternate parent, change, change, parent, ...
Prints the card's name and power limit, one JSON line per run and a summary
line: each side's µs per query on the first query and on the repeats.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def child(root: str, repeats: int) -> None:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch import dslsh
    from repro_torch.kernels import _build

    _build.build()
    pts, _, qx, _ = cs.synth(cs.N, cs.NQ)
    dev = torch.device("cuda")
    cfg = dslsh.make_config(**cs.CFG, backend="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = dslsh.build(cs.SEED, pts, cfg, dslsh.grid(nu=cs.NU, p=cs.P), dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    us = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        index.query(qx)
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t0) / cs.NQ * 1e6)
    print(json.dumps({"root": root, "build_s": build_s, "us_per_query": us}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.repeats)
        return 0
    parent, change = (os.path.abspath(r) for r in args.roots)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    order = []
    for i in range(args.pairs):
        order += [parent, change] if i % 2 == 0 else [change, parent]
    runs = {parent: [], change: []}
    for root in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                              "--repeats", str(args.repeats)], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[root].append(json.loads(line)["us_per_query"])
    print(json.dumps({side: {"first": [r[0] for r in runs[root]], "repeats": [u for r in runs[root] for u in r[1:]]}
                      for side, root in (("parent", parent), ("change", change))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
