"""Time kernel F (flash attention) of two checkouts of the repository, in
pairs.

    python3 scripts/flash_pairs.py PARENT_ROOT CHANGE_ROOT [--pairs 2]

Each run is a fresh process that imports ``repro_torch`` from one root's
``src/``, builds that root's ``flash_attention.cu`` alone and times one
launch of F at the ``knn_lm`` phase's shapes of ``chip_smoke.py`` that
both checkouts take (no sink mask): the datastore pass, a 128-token
prefill, the 4-row decode step and the 256-key window, with granite-8b's
heads, as ``chip_smoke.timed_ms`` times them (CUDA events, a cold L2 each
launch, 20 launches) and as the profiler sees them (summed kernel time,
``chip_smoke.device_profile``). Runs alternate parent, change, change,
parent, ... Prints the card's name and power limit, one JSON line per run
and a summary line: each side's times per case.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def child(root: str) -> None:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa

    _build.build(("flash_attention",))
    dev = torch.device("cuda")
    cfg = configs.get(cs.LM_ARCH)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    max_len = cs.PROMPT_LEN + cs.MAX_NEW + 8
    ragged = torch.tensor([max_len - 15, max_len - 7, max_len - 3, max_len], dtype=torch.int32, device=dev)
    cases = {
        "datastore": dict(b=cs.DS_CHUNK, sq=cs.DS_LEN - 1, skv=cs.DS_LEN - 1, kw=dict(causal=True)),
        "prefill": dict(b=1, sq=cs.PROMPT_LEN, skv=cs.PROMPT_LEN, kw=dict(causal=True)),
        "decode": dict(b=cs.N_REQ, sq=1, skv=max_len, kw=dict(causal=False, q_offset=ragged - 1, kv_len=ragged)),
        "window": dict(b=1, sq=cs.DS_LEN - 1, skv=cs.DS_LEN - 1, kw=dict(causal=True, window=256)),
    }
    g = torch.Generator(dev).manual_seed(cs.SEED)
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    out = {}
    for name, c in cases.items():
        q = torch.randn((c["b"], c["sq"], hq, dh), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
        k, v = (torch.randn((c["b"], c["skv"], hkv, dh), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
                for _ in range(2))

        def call(q=q, k=k, v=v, kw=c["kw"]):
            return fa.flash_attention(q, k, v, **kw)

        out[name] = dict(ms=cs.timed_ms(call, 20, scratch.zero_), device_ms=cs.device_profile(call)["device_ms"])
    print(json.dumps({"root": root, "cases": out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child)
        return 0
    parent, change = (os.path.abspath(r) for r in args.roots)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    order = []
    for i in range(args.pairs):
        order += [parent, change] if i % 2 == 0 else [change, parent]
    runs = {parent: [], change: []}
    for root in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[root].append(json.loads(line)["cases"])
    print(json.dumps({side: {case: {key: [r[case][key] for r in runs[root]] for key in ("ms", "device_ms")}
                             for case in runs[root][0]}
                      for side, root in (("parent", parent), ("change", change))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
