"""hymba-1.5b's one-process step-0 check at cut depths, on the card, with
the orders that explain its tolerance.

    python3 scripts/hymba_step0_depth.py [--device cuda] [--smoke] [--depths 16,8]

For each depth (the layers cut from the top, a first, a middle and a last
global layer kept: 16 layers take 0, 7 and 15, 8 take 0, 3 and 7), the
masters from ``chip_smoke.py``'s seed and the first row and 256 tokens of
its ``families_train`` step-0 batch, this computes the loss and gradients
of the training path and of five variants and holds each against the
training path (max |a - b| and cosine per leaf, ``chip_smoke.grad_stats``):

* ``other_order``: query and SSD chunks halved, the ``families_train``
  rule's floor (its tolerance is 2^-5 of a leaf's largest element plus
  twice this gap);
* ``quarter_order``: query and SSD chunks quartered, a second float32
  order;
* ``plain``: the rule's reference (one attention block, whole logits,
  ``ssd_reference`` under remat "full");
* ``plain_ssd``: the training path with only the SSD swapped for
  ``ssd_reference`` (and remat "full");
* ``plain_attention``: the training path with only attention and the loss
  in one block.

Prints the card's name and power limit, then one JSON line per depth: the
rule's verdict on every leaf against ``plain`` (the leaves past their
tolerance), and for the worst leaves each variant's error over the leaf's
largest element. ``--smoke`` takes hymba's smoke config (3 layers, no cut)
to rehearse it on the CPU with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "hymba-1.5b"
GLOBAL = {32: (0, 15, 31), 16: (0, 7, 15), 8: (0, 3, 7)}


def variant(cfg, params, rows, kind: str):
    """The loss and every master leaf's gradient on ``rows`` by ``kind``."""
    import chip_smoke
    from repro_torch.models import api as mapi
    from repro_torch.train import loop as tl

    s_tot = rows["tokens"].shape[1] + cfg.meta_tokens
    if kind in ("train", "other_order", "plain"):
        return chip_smoke.family_loss_variant(cfg, params, rows, kind)
    if kind == "quarter_order":
        cfg = dataclasses.replace(cfg, q_chunk=max(cfg.q_chunk // 4, 1), ssm_chunk=max(cfg.ssm_chunk // 4, 1))
    elif kind == "plain_ssd":
        cfg = dataclasses.replace(cfg, remat="full")
    elif kind == "plain_attention":
        cfg = dataclasses.replace(cfg, q_chunk=s_tot, loss_chunk=rows["tokens"].shape[1])
    model = mapi.build_model(cfg)
    with chip_smoke.plain_ssd() if kind == "plain_ssd" else contextlib.nullcontext():
        return tl._value_and_grad(model, params, rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--depths", default="16,8")
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch

    import chip_smoke
    from repro_torch import configs
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.launch import train as launch_train
    from repro_torch.models import api as mapi

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("hymba_step0_depth: no CUDA device is available", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    base = configs.get(ARCH, smoke=args.smoke)
    batch_n, seq = chip_smoke.FT_BATCH[ARCH]
    rows_n, prefix = chip_smoke.FT_CHECK[ARCH]
    if args.smoke:
        batch_n, seq, rows_n, prefix = 4, 32, 1, 32
    depths = [base.n_layers] if args.smoke else [int(d) for d in args.depths.split(",")]
    kinds = ("other_order", "quarter_order", "plain", "plain_ssd", "plain_attention")
    for depth in depths:
        cfg = base if args.smoke else dataclasses.replace(base, n_layers=depth, global_layers=GLOBAL[depth])
        params = mapi.build_model(cfg).init_masters(chip_smoke.SEED, dev)
        batch = launch_train.make_batch(cfg, TokenStream(cfg.vocab, seed=3).batch(batch_n, seq), 0, dev)
        rows = {"tokens": batch["tokens"][:rows_n, :prefix]}
        names = list(chip_smoke._flat(params))
        loss_t, grads_t = variant(cfg, params, rows, "train")
        stats, losses = {}, {"train": float(loss_t)}
        for kind in kinds:
            loss, grads = variant(cfg, params, rows, kind)
            losses[kind] = float(loss)
            stats[kind] = [chip_smoke.grad_stats(gt, g) for gt, g in zip(grads_t, grads)]
            del grads
        past, worst = [], []
        for i, name in enumerate(names):
            gap = stats["other_order"][i][0]
            err, scale, cos = stats["plain"][i]
            tol = chip_smoke.TRAIN_GRAD_FRAC * scale + 2 * gap
            worst.append((err / max(tol, 1e-30), name, i))
            if err > tol or cos < chip_smoke.TRAIN_GRAD_COS - 2 * (1.0 - stats["other_order"][i][2]):
                past.append(name)
        worst.sort(reverse=True)
        print(json.dumps(dict(
            arch=cfg.name, n_layers=cfg.n_layers, global_layers=list(cfg.global_layers), rows=rows_n, tokens=prefix,
            losses=losses, leaves=len(names), past_tolerance=past,
            worst=[dict(leaf=name, err_over_tolerance=r, scale=stats["plain"][i][1],
                        tolerance=chip_smoke.TRAIN_GRAD_FRAC * stats["plain"][i][1] + 2 * stats["other_order"][i][0],
                        **{k: dict(err=stats[k][i][0], frac=stats[k][i][0] / max(stats[k][i][1], 1e-30),
                                   cosine=stats[k][i][2]) for k in kinds})
                   for r, name, i in worst[:6]])), flush=True)
        del params, grads_t
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
