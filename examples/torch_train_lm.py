"""End-to-end training on the PyTorch/CUDA port: train a ~10M-param (or,
with ``--full-100m``, ~100M-param) granite-family model on the synthetic
token stream, with checkpointing and crash-resume — the twin of
``examples/train_lm.py``.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given. The weights are
drawn from seed 0 by the port's generator (other numbers than
``jax.random``'s); :func:`main` takes ``params``, a parameter tree such as
the JAX package's ``build_model(cfg).init(PRNGKey(0))`` as numpy arrays,
to start from the same weights instead. Checkpoints go to
``build/torch_train_lm`` in the repository (git-ignored) unless
``--ckpt-dir`` says otherwise; a run resumes from the newest one there.
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch import device as device_mod
from repro_torch import params as params_mod
from repro_torch.checkpoint import store
from repro_torch.data.lm_data import TokenStream
from repro_torch.models import api
from repro_torch.models.api import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import loop as tl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ~100M params: granite-family (llama-style)
CFG_100M = ModelConfig(
    name="granite-100m", family="dense",
    n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
    d_ff=1536, vocab=4096, mlp="swiglu", q_chunk=128, loss_chunk=128,
    microbatches=2,
)
# ~10M: same family, sized for one CPU core
CFG_10M = ModelConfig(
    name="granite-10m", family="dense",
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=768, vocab=1024, mlp="swiglu", q_chunk=64, loss_chunk=64,
)


def main(*, steps: int = 200, batch: int = 4, seq: int = 64, full_100m: bool = False, ckpt_dir: str | None = None,
         ckpt_every: int = 100, params=None, device=None) -> list[float]:
    """Trains for ``steps`` steps (resuming from ``ckpt_dir`` when it holds
    a checkpoint; ``""`` turns checkpointing off) and returns each step's
    loss."""
    dev = device_mod.resolve(device)
    cfg = CFG_100M if full_100m else CFG_10M
    model = api.build_model(cfg)
    print(f"model: {cfg.name}  params={model.n_params/1e6:.1f}M")

    opt_cfg = adamw.AdamWConfig(peak_lr=3e-4, warmup_steps=20, total_steps=steps, weight_decay=0.01)
    if params is None:
        p = model.init_masters(0, dev)
    else:
        p, _ = params_mod.train_state_from_numpy(cfg, params, device=dev)
    state = adamw.init(p, opt_cfg)
    start = 0
    ckpt_dir = os.path.join(ROOT, "build", "torch_train_lm") if ckpt_dir is None else ckpt_dir
    if ckpt_dir:
        restored, at = store.restore_latest({"params": p, "opt": state}, ckpt_dir, dev)
        if restored is not None:
            p, _ = params_mod.train_state_from_numpy(cfg, restored["params"], device=dev)
            state, start = restored["opt"], at
            print(f"resumed from checkpoint at step {at}")

    step_fn = tl.make_train_step(model, opt_cfg)
    stream = TokenStream(cfg.vocab, seed=0)
    losses = []
    t0 = time.time()
    for i, b in enumerate(stream.batches(steps - start, batch, seq), start=start):
        p, state, m = step_fn(p, state, {"tokens": b["tokens"]})
        losses.append(float(m["loss"]))
        if i % 20 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss={losses[-1]:.4f}  gnorm={float(m['grad_norm']):.3f}  "
                  f"lr={float(m['lr']):.2e}  ({(time.time()-t0):.1f}s)")
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            store.save({"params": p, "opt": state}, i + 1, ckpt_dir)
            print(f"checkpointed step {i+1}")
    if losses:
        print("done. final loss:", losses[-1])
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-100m", action="store_true",
                    help="train the ~100M config (the default is a ~10M config sized for 1 CPU core)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None, help="'cpu' to run without the card")
    a = ap.parse_args()
    main(steps=a.steps, batch=a.batch, seq=a.seq, full_100m=a.full_100m, ckpt_dir=a.ckpt_dir,
         ckpt_every=a.ckpt_every, device=a.device)
