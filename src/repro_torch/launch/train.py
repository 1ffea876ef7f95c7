"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device ...]``.

Counterpart of ``repro.launch.train``: the microbatched train step with
AdamW on the synthetic token stream (or, for the audio and vision front
ends, the batches the JAX launcher makes), resuming from the newest
checkpoint in ``--ckpt-dir`` and saving every ``--ckpt-every`` steps. It
runs on the CUDA card unless ``--device`` says otherwise, and there it
takes a FULL config; on the CPU it needs ``--smoke``. ``--mesh
single-pod`` / ``multi-pod`` runs it under the production mesh (16 x 16 or
2 x 16 x 16 ranks), which needs an initialized process group of that many
ranks (``torchrun``) and otherwise refuses with ``ctx.make_mesh``'s
message. :func:`train` takes any ``ctx.Mesh``, so tests and
``chip_smoke.py`` drive it through ``launch.mesh.spawn`` with
``make_local_mesh(2, 2)``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.checkpoint import store
from repro_torch.data.lm_data import TokenStream
from repro_torch.models import api, dense
from repro_torch.models import params as PM
from repro_torch.obs import clock
from repro_torch.optim import adamw
from repro_torch.sharding import ctx
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


def state_shardings(model, mesh, opt_cfg: adamw.AdamWConfig) -> dict:
    """The ``NamedSharding`` tree of ``{"params", "opt"}`` on ``mesh``: the
    masters' JAX specs and the moments' layout of
    ``train.loop.opt_state_structs`` (8-bit block scales whole along a
    quantization axis their block does not divide), the step whole."""
    psh = PM.tree_map(lambda p: PM.sharding_of(p, mesh), model.defs)
    structs = tl.opt_state_structs(model, mesh, opt_cfg)

    def sh(t):
        return {k: sh(v) for k, v in t.items()} if isinstance(t, dict) else t.sharding

    return {"params": psh, "opt": adamw.AdamWState(sh(structs.m), sh(structs.v), structs.step.sharding)}


def gather_state(mesh, shardings, tree):
    """The whole of every leaf of ``tree`` (this rank's blocks), all-gathered
    along every dim its sharding splits (one or several), on every rank."""
    if isinstance(tree, dict):
        return {k: gather_state(mesh, shardings[k], tree[k]) for k in tree}
    if isinstance(tree, tuple):
        return type(tree)(*(gather_state(mesh, s, t) for s, t in zip(shardings, tree)))
    t = tree.detach()
    for dim, axes in enumerate(shardings.spec):
        if axes is not None:
            t = ctx.all_gather_tiled(mesh, axes, t, dim)
    return t


def save_state(mesh, model, opt_cfg, params, state, step: int, ckpt_dir: str):
    """Save ``{"params", "opt"}`` in the JAX package's format, as one process
    does. Under a mesh every rank gathers the split leaves and rank 0
    writes (blocking); returns the writer thread, or None."""
    tree = {"params": params, "opt": state}
    if mesh is None:
        return store.save(tree, step, ckpt_dir, blocking=False)[1]
    with torch.no_grad():
        whole = gather_state(mesh, state_shardings(model, mesh, opt_cfg), tree)
    if mesh.rank == 0:
        store.save(whole, step, ckpt_dir)
    ctx.barrier(mesh)
    return None


def train(cfg, *, steps: int = 50, batch: int = 4, seq: int = 64, lr: float = 1e-3, ckpt_dir: str = "",
          ckpt_every: int = 25, device=None, mesh=None, params=None, log=print, on_step=None):
    """Train ``cfg`` for ``steps`` steps on the synthetic token stream ->
    ``(history, params, state)``, each step's metrics as floats.

    With ``mesh`` (a ``ctx.Mesh``) the step runs data-, expert- and
    tensor-parallel with ZeRO under it: every rank draws the same global
    batch from the stream and keeps its block of rows, holds its blocks of
    the masters (drawn whole and cut, so the one-process values) and of
    the moments under the JAX spec, restores its blocks of a checkpoint and
    saves the whole tree from rank 0.
    ``params`` are masters already drawn (this rank's blocks under a
    mesh); None draws them from seed 0. ``on_step(i, params, state)`` is
    called after each step."""
    dev = mesh.device if mesh is not None else device_mod.resolve(device)
    model = api.build_model(cfg)
    opt_cfg = adamw.AdamWConfig(
        peak_lr=lr, warmup_steps=max(steps // 10, 1),
        total_steps=steps, state_bits=cfg.opt_state_bits,
    )
    with ctx.use_mesh(mesh):
        if params is None:
            params = model.init_masters(0, dev)
        state = tl.init_state(model, params, opt_cfg)
        start = 0
        if ckpt_dir:
            at = store.latest_step(ckpt_dir)
            if at is not None:
                tree = {"params": params, "opt": state}
                sh = None if mesh is None else state_shardings(model, mesh, opt_cfg)
                restored = store.restore(tree, at, ckpt_dir, dev, shardings=sh)
                params, state, start = dense.master_tree(restored["params"]), restored["opt"], at
                log(f"resumed at step {at}")
        step_fn = tl.make_train_step(model, opt_cfg)
        stream = TokenStream(cfg.vocab, seed=0)
        rows = None if mesh is None else ctx.sharding_for(mesh, ("batch", None), (batch, seq))
        history, writers = [], []
        t0 = clock.monotonic()
        for i, b in enumerate(stream.batches(steps - start, batch, seq), start=start):
            toks = b["tokens"] if rows is None else rows.block(b["tokens"])
            params, state, m = step_fn(params, state, make_batch(cfg, toks, i, dev))
            history.append({k: float(v) for k, v in m.items()})
            if on_step is not None:
                on_step(i, params, state)
            if i % 10 == 0 or i == steps - 1:
                log(f"step {i:4d} loss={history[-1]['loss']:.4f} "
                    f"gnorm={history[-1]['grad_norm']:.3f} ({clock.monotonic() - t0:.1f}s)")
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                writers.append(save_state(mesh, model, opt_cfg, params, state, i + 1, ckpt_dir))
        for w in writers:
            if w is not None:
                w.join()
    return history, params, state


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

    cfg = configs.get(args.arch, smoke=args.smoke)
    dev = device_mod.resolve(args.device)
    mesh = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import make_production_mesh

        # a production mesh needs its 256 or 512 ranks' process group
        mesh = make_production_mesh(multi_pod=args.mesh == "multi-pod", device=dev)
    if not args.smoke and dev.type != "cuda":
        raise SystemExit("FULL configs need real accelerators; use --smoke on CPU")

    model = api.build_model(cfg)
    print(f"arch={cfg.name} params={model.n_params/1e6:.1f}M family={cfg.family} device={dev.type}"
          f" mesh={args.mesh}")
    history, _, _ = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, device=dev, mesh=mesh)
    if history:
        print("final loss:", history[-1]["loss"])
    return history


if __name__ == "__main__":
    main()
