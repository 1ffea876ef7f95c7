"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device ...]``.

Counterpart of ``repro.launch.train``: the microbatched train step with
AdamW on the synthetic token stream (or, for the audio and vision front
ends, the batches the JAX launcher makes), resuming from the newest
checkpoint in ``--ckpt-dir`` and saving every ``--ckpt-every`` steps. It
runs on the CUDA card unless ``--device`` says otherwise, and there it
takes a FULL config; on the CPU it needs ``--smoke``. There is no mesh:
``--mesh`` other than ``none`` is refused (LM training under a mesh is
still to port, see ROADMAP.md).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.checkpoint import store
from repro_torch.data.lm_data import TokenStream
from repro_torch.models import api, dense
from repro_torch.obs import clock
from repro_torch.optim import adamw
from repro_torch.train import loop as tl


def make_batch(cfg, tokens, step: int, dev: torch.device) -> dict:
    """The batch of ``step`` as the JAX launcher makes it: the stream's
    tokens (with zero patch embeddings for the vision front end), or for
    the audio front end normal frames, a 30 % frame mask and uniform
    targets, drawn from a generator seeded with the step."""
    b, s = tokens.shape
    if cfg.frontend == "audio":
        gen = torch.Generator(dev).manual_seed(step)
        return {
            "frames": torch.randn((b, s, cfg.frontend_dim), generator=gen, device=dev),
            "frame_mask": torch.rand((b, s), generator=gen, device=dev) < 0.3,
            "targets": torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev, dtype=torch.int32),
        }
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.zeros((b, cfg.frontend_len, cfg.frontend_dim), device=dev)
    return batch


def main(argv: list[str] | None = None) -> list[dict]:
    """Runs the launcher; returns each step's metrics as floats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", choices=["none", "single-pod", "multi-pod"], default="none")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise SystemExit(f"--mesh {args.mesh}: LM training under a mesh is not ported yet (see ROADMAP.md)")
    cfg = configs.get(args.arch, smoke=args.smoke)
    dev = device_mod.resolve(args.device)
    if not args.smoke and dev.type != "cuda":
        raise SystemExit("FULL configs need real accelerators; use --smoke on CPU")

    model = api.build_model(cfg)
    print(f"arch={cfg.name} params={model.n_params/1e6:.1f}M family={cfg.family} device={dev.type}")
    opt_cfg = adamw.AdamWConfig(
        peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps, state_bits=cfg.opt_state_bits,
    )
    params = model.init_masters(0, dev)
    state = adamw.init(params, opt_cfg)
    start = 0
    if args.ckpt_dir:
        restored, at = store.restore_latest({"params": params, "opt": state}, args.ckpt_dir, dev)
        if restored is not None:
            params, state, start = dense.master_tree(restored["params"]), restored["opt"], at
            print(f"resumed at step {at}")
    step_fn = tl.make_train_step(model, opt_cfg)
    stream = TokenStream(cfg.vocab, seed=0)
    history, writers = [], []
    t0 = clock.monotonic()
    for i, b in enumerate(stream.batches(args.steps - start, args.batch, args.seq), start=start):
        params, state, m = step_fn(params, state, make_batch(cfg, b["tokens"], i, dev))
        history.append({k: float(v) for k, v in m.items()})
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={history[-1]['loss']:.4f} "
                  f"gnorm={history[-1]['grad_norm']:.3f} ({clock.monotonic() - t0:.1f}s)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            writers.append(store.save({"params": params, "opt": state}, i + 1, args.ckpt_dir, blocking=False)[1])
    for w in writers:
        w.join()
    if history:
        print("final loss:", history[-1]["loss"])
    return history


if __name__ == "__main__":
    main()
