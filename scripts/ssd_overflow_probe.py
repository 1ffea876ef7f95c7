"""Step-0 gradients of mamba2-780m and hymba-1.5b at FULL size with the SSD
decay in the JAX package's form, on the card.

    python3 scripts/ssd_overflow_probe.py [--device cuda] [--smoke]

The port's ``ssd_chunked`` masks the intra-chunk decay's exponent before
the exp (``exp(where(causal, li, -inf))``); the JAX package computes
``where(causal, exp(li), 0)``, whose backward pass gives ``0 * inf = NaN``
once an exponent above the diagonal passes float32's exp range (ROADMAP.md,
Queue 3). This script copies the repository's ``src/`` into a temporary
directory under ``build/``, writes the JAX package's form into the copy,
and computes the loss and gradients of each model on the first row and
256 tokens of ``chip_smoke.py``'s ``families_train`` step-0 batch (masters
from seed 0), then the same with the unaltered port. Prints the card's
name and power limit and one JSON line per model and form: the loss and
the leaves whose gradient is not finite. ``--smoke`` takes the smoke
configs (chunk 16, which never overflows) to rehearse it on the CPU with
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASKED = '            lmat = torch.exp(torch.where(causal, li, float("-inf")))'
JAX_FORM = "            lmat = torch.where(causal, torch.exp(li), 0.0)"
ARCHS = ("mamba2-780m", "hymba-1.5b")
ROWS, TOKENS = 1, 256


def child(src: str, form: str, device: str, smoke: bool) -> None:
    sys.path.insert(0, src)
    import torch

    from repro_torch import configs
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.models import api
    from repro_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ARCHS:
        cfg = configs.get(arch, smoke=smoke)
        model = api.build_model(cfg)
        params = model.init_masters(0, device)
        tokens = torch.as_tensor(TokenStream(cfg.vocab, seed=3).batch(4, 512), device=device)
        tokens = tokens[:ROWS, : 32 if smoke else TOKENS]
        loss, grads = loop._value_and_grad(model, params, {"tokens": tokens})
        names = []

        def walk(tree, prefix=""):
            for k in sorted(tree):
                if isinstance(tree[k], dict):
                    walk(tree[k], f"{prefix}{k}/")
                else:
                    names.append(prefix + k)

        walk(params)
        bad = [n for n, g in zip(names, grads) if not bool(torch.isfinite(g).all())]
        print(json.dumps({"arch": cfg.name, "decay": form, "rows": ROWS, "tokens": tokens.shape[1], "loss": float(loss),
                          "leaves": len(names), "nonfinite_leaves": bad}), flush=True)
        del params, grads, model
        if device == "cuda":
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--child", nargs=2, metavar=("SRC", "FORM"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(*args.child, args.device, args.smoke)
        return 0
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        src = os.path.join(tmp, "src")
        shutil.copytree(os.path.join(ROOT, "src"), src)
        path = os.path.join(src, "repro_torch", "models", "mamba2.py")
        with open(path) as f:
            text = f.read()
        if MASKED not in text:
            raise SystemExit("the masked decay line is not in models/mamba2.py")
        with open(path, "w") as f:
            f.write(text.replace(MASKED, JAX_FORM))
        for where, form in ((src, "jax_form"), (os.path.join(ROOT, "src"), "masked")):
            subprocess.run([sys.executable, __file__, "--device", args.device, "--child", where, form]
                           + (["--smoke"] if args.smoke else []), check=True)
    finally:
        shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
