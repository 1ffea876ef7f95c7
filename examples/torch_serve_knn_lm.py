"""Serve a small LM with SLSH-kNN-LM augmentation on the PyTorch/CUDA port
— the twin of ``examples/serve_knn_lm.py``.

A datastore of (hidden state -> next token) pairs is indexed with
stratified LSH (bit-sampling outer layer on the hidden values, cosine
inner layer on heavy buckets), sharded over the DSLSH grid, and queried
at every decode step; the retrieved neighbours' next-token histogram is
interpolated with the LM distribution. Steps: train the LM (AdamW,
``launch``'s train step), build the datastore over the trained model's
hidden states on ``grid(nu=2, p=4)``, serve 6 requests with lmbda 0 and
0.3. On the card the forward passes run kernel F and the datastore
kernels A, B and D.

Run:  PYTHONPATH=src python examples/torch_serve_knn_lm.py [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given. :func:`main`
takes ``params`` (for instance the JAX package's initial parameter tree
as numpy arrays) and ``steps``, to train from the same weights for fewer
steps.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import dslsh
from repro_torch import params as params_mod
from repro_torch.data.lm_data import TokenStream
from repro_torch.models import api, dense
from repro_torch.models.api import ModelConfig
from repro_torch.optim import adamw
from repro_torch.serve import engine
from repro_torch.train import loop as tl

CFG = ModelConfig(
    name="serve-demo", family="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab=512, mlp="swiglu", q_chunk=64, loss_chunk=64,
)
FAMILY = dict(m_out=24, L_out=8, m_in=12, L_in=4, alpha=0.02)
BUDGET = dslsh.BudgetConfig(k=8, c_max=64, c_in=16, h_max=4, p_max=128)


def accuracy(stream: TokenStream, reqs, gens) -> float:
    """The share of generated tokens equal to the noise-free motif's
    continuation, its phase read from the prompt's last four tokens."""
    acc = []
    per = stream.period
    for r, g in zip(reqs, gens):
        ctx = list(r.tokens)
        phase = int(np.argmax([np.array_equal(stream.motif[(np.arange(len(ctx)) + ph) % per][-4:], ctx[-4:])
                               for ph in range(per)]))
        want = [stream.motif[(phase + len(ctx) + t) % per] for t in range(len(g))]
        acc.append(np.mean(np.asarray(g) == np.asarray(want)))
    return float(np.mean(acc))


def main(*, params=None, steps: int = 120, device=None, backend: str = "cuda") -> dict:
    """Returns the training losses, the generated tokens and accuracies by
    lmbda, and every hook call as ``(logits in, logits out, query hidden
    state)``, with the index and its labels."""
    dev = device_mod.resolve(device)
    model = api.build_model(CFG)
    stream = TokenStream(CFG.vocab, seed=3)

    # -- 1. quick-train so the LM carries signal
    opt_cfg = adamw.AdamWConfig(peak_lr=3e-3, warmup_steps=10, total_steps=120)
    if params is None:
        masters = model.init_masters(0, dev)
    else:
        masters, _ = params_mod.train_state_from_numpy(CFG, params, device=dev)
    state = adamw.init(masters, opt_cfg)
    step_fn = tl.make_train_step(model, opt_cfg)
    losses = []
    for b in stream.batches(steps, 8, 64):
        masters, state, m = step_fn(masters, state, {"tokens": b["tokens"]})
        losses.append(float(m["loss"]))
    print(f"trained demo LM to loss={losses[-1]:.3f}")
    lm = model.serving(masters)  # frozen bf16 weights: kernel F on the card
    del masters, state

    # -- 2. build the SLSH datastore over hidden states
    # keys: final hidden state at position t; value: token t+1
    ds_tokens = torch.as_tensor(stream.batch(32, 64), device=dev)

    def hidden_states(tokens):
        x, _ = dense._embed_inputs(CFG, lm, {"tokens": tokens})
        return dense._run_layers(CFG, lm, x, torch.arange(tokens.shape[1], device=dev))

    with torch.no_grad():
        h = hidden_states(ds_tokens)  # (B, S, D)
    keys = h[:, :-1].reshape(-1, CFG.d_model).float().cpu().numpy()
    next_tokens = ds_tokens[:, 1:].reshape(-1).cpu().numpy()
    deploy = dslsh.grid(nu=2, p=4)
    slsh_cfg = dslsh.make_config(
        dslsh.FamilyConfig(**FAMILY, val_lo=float(keys.min()), val_hi=float(keys.max())), BUDGET, backend=backend,
    )
    pts, labs, _ = dslsh.pad_to_multiple(keys, next_tokens, deploy.cells)
    index = dslsh.build(9, pts, slsh_cfg, deploy, dev)
    print(f"SLSH datastore: {keys.shape[0]} hidden states, grid nu=2 p=4")

    # -- 3. serving with the kNN hook
    prompts = [np.asarray(stream.batch(1, 16)[0]) for _ in range(6)]
    reqs = [engine.Request(rid=i, tokens=p, max_new=8) for i, p in enumerate(prompts)]
    calls = []

    def run_serve(lmbda: float):
        seen = []

        def hidden_fn(cur):
            # the hook's carrier is the running token tensor here
            seen.append(hidden_states(cur)[:, -1])
            return seen[-1]

        hook = engine.make_knn_lm_hook(index, labs, hidden_fn=hidden_fn, vocab=CFG.vocab, lmbda=lmbda)
        out_tokens = []
        for r in reqs:
            toks = torch.as_tensor(r.tokens[None, :].astype(np.int32), device=dev)
            logits, cache = model.prefill(lm, {"tokens": toks}, 64)
            cur, gen = toks, []
            for _ in range(r.max_new):
                if lmbda > 0:
                    mixed = hook(logits, cur)
                    calls.append((logits, mixed, seen[-1]))
                    logits = mixed
                nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
                gen.append(int(nxt[0, 0]))
                logits, cache = model.decode_step(lm, cache, nxt)
                cur = torch.cat([cur, nxt], dim=1)
            out_tokens.append(gen)
        return out_tokens

    with torch.no_grad():
        gens = {lmbda: run_serve(lmbda) for lmbda in (0.0, 0.3)}
    acc = {lmbda: accuracy(stream, reqs, g) for lmbda, g in gens.items()}
    print(f"LM-only   continuation accuracy: {acc[0.0]:.2f}")
    print(f"+SLSH-kNN continuation accuracy: {acc[0.3]:.2f}")
    print("served", len(reqs), "batched requests (latency-first engine)")
    return dict(losses=losses, tokens=gens, accuracy=acc, hook_calls=calls, index=index,
                labels=torch.as_tensor(labs, device=dev), config=slsh_cfg)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default=None, help="'cpu' to run without the card")
    a = ap.parse_args()
    main(steps=a.steps, device=a.device)
