"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Counterpart of ``repro.launch.serve``: latency-first batched greedy
decoding of a few synthetic prompts through ``ServeEngine``, with weights
drawn from a seeded generator. It runs on the CUDA card unless ``--device``
says otherwise, and there it takes a FULL config; on the CPU it keeps the
JAX launcher's refusal of a FULL config and needs ``--smoke``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.data.lm_data import TokenStream
from repro_torch.models import api
from repro_torch.obs import clock
from repro_torch.serve import engine


def main(argv: list[str] | None = None) -> list[engine.Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch, smoke=args.smoke)
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving path")
    dev = device_mod.resolve(args.device)
    if not args.smoke and dev.type != "cuda":
        raise SystemExit("FULL configs need real accelerators; use --smoke on CPU")

    model = api.build_model(cfg)
    params = model.init(0, dev)
    stream = TokenStream(cfg.vocab, seed=1)
    reqs = [
        engine.Request(
            rid=i, tokens=np.asarray(stream.batch(1, args.prompt_len)[0]),
            max_new=args.max_new,
        )
        for i in range(args.requests)
    ]
    eng = engine.ServeEngine(
        model, params, max_batch=args.requests,
        max_len=args.prompt_len + args.max_new + 8,
    )
    t0 = clock.monotonic()
    done = eng.serve(reqs)
    dur = clock.monotonic() - t0
    for r in done:
        print(f"req {r.rid}: {r.tokens[-4:].tolist()} -> {r.result}  "
              f"({r.latency_s*1e3:.0f} ms)")
    print(f"served {len(done)} requests in {dur:.2f}s "
          f"(arch={cfg.name}, params={model.n_params/1e6:.1f}M, device={dev.type})")
    return done


if __name__ == "__main__":
    main()
