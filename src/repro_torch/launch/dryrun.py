"""Dry-run of the production meshes: trace one rank's program of every
(architecture x input-shape) cell on ``meta`` tensors and report its
memory, FLOPs and collective bytes (the counterpart of
``repro.launch.dryrun``).

JAX lowers and compiles each cell against 512 host devices, GSPMD placing
every array, and reads the compiled program's memory and cost analyses
and its HLO text. The port runs one program per rank (``sharding.ctx``),
so it traces rank 0's program instead, on a *dry mesh*
(``ctx.dry_mesh``: the production mesh's shape, no process group, the
``meta`` device) through the entry point ``lower_cell`` picks: the train
step (``train.loop.make_train_step``), the prefill, or one decode step.
Nothing is allocated and nothing is compiled: every tensor is a ``meta``
tensor of the rank's block shape, and the dry collectives return outputs
of the right shape and add their output bytes to ``ctx.DRY_BYTES`` under
the HLO names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
``all-to-all``, ``collective-permute``). JAX's HLO-text parser
``collective_bytes`` has no input here (no HLO exists), so it is not
copied: the dry collectives count the bytes themselves.

Each record keeps the JAX record's keys where they mean the same thing:
``status`` (``ok``/``skip``/``fail``, with ``cell_skip_reason``'s reasons),
``devices``, ``n_params``, ``param_bytes``, ``opt_bytes`` and
``cache_bytes`` (over the global structs, as ``_tree_bytes`` does),
``flops`` (``torch.utils.flop_counter.FlopCounterMode`` over one rank's
trace) and ``collective_bytes`` (one rank). ``memory`` is the port's own:
per rank, the bytes of the blocks it holds under the JAX spec
(``sharding.ctx``: every axis split) — its parameters, and for a train
cell its gradients and optimizer state, for a serving cell its serving
weights and cache — as ``rank_bytes``, and ``spec_bytes``, the bytes the
spec puts on one device, which they equal. A cell whose rank bytes exceed
the card's 80 GB is ``fail``, with that as its reason: a finding, as
JAX's failing cells are.

Usage (on the CPU)::

  python -m repro_torch.launch.dryrun --arch phi3.5-moe-42b-a6.6b --cell train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.models import api
from repro_torch.models import params as PM
from repro_torch.optim import adamw
from repro_torch.sharding import ctx
from repro_torch.train import loop as train_loop

CARD_BYTES = 80e9  # one H100's device memory
MESHES = {False: (("data", "model"), (16, 16)), True: (("pod", "data", "model"), (2, 16, 16))}


def _nbytes(shape, dtype) -> float:
    return float(torch.empty((), dtype=dtype).element_size()) * float(math.prod(shape))


def _tree_bytes(tree) -> float:
    """Bytes of every struct of ``tree`` at its global shape."""
    return sum(_nbytes(s.shape, s.dtype) for s in adamw._leaves(tree))


def _rank_bytes(tree) -> tuple[float, float]:
    """(bytes of the meta blocks the traced program takes, bytes of the
    blocks the JAX spec puts on one device) of a tree of structs with
    shardings."""
    held = sum(float(t.numel() * t.element_size()) for t in adamw._leaves(_blocks(tree)))
    return held, float(PM.block_bytes(tree))


def _blocks(tree, requires_grad: bool = False):
    """A meta tensor of each struct's block shape (what a rank holds)."""
    if isinstance(tree, dict):
        return {k: _blocks(v, requires_grad) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_blocks(t, requires_grad) for t in tree))
    t = torch.empty(tree.sharding.block_shape(tree.shape), dtype=tree.dtype, device="meta")
    return t.requires_grad_() if requires_grad and t.is_floating_point() else t


def _serving_structs(model, mesh) -> dict:
    """The serving weights' structs: the masters' layout in the storage
    dtypes the port serves with (bf16 matmul weights and embeddings)."""
    mod = api._family_module(model.cfg)
    return PM.param_structs(mod.storage_defs(model.defs), mesh)


def _cache_structs(model, batch: int, max_len: int, mesh) -> dict:
    """The cache prefill fills (``batch`` rows, ``max_len`` positions) as
    structs with their shardings."""
    mod = api._family_module(model.cfg)

    def leafify(t, logical):
        if isinstance(t, dict):
            return {k: leafify(t[k], logical[k]) for k in t}
        return PM.struct(t.shape, t.dtype, ctx.sharding_for(mesh, logical, t.shape))

    return leafify(mod.init_cache(model.cfg, batch, max_len, device="meta"), mod.cache_logical_axes(model.cfg))


def lower_cell(arch_id: str, cell: str, mesh):
    """Returns (trace, aux) for one (arch, cell) on the dry ``mesh``:
    ``trace()`` runs rank 0's program on meta tensors under the mesh;
    ``aux`` holds the byte counts."""
    cfg = configs.get(arch_id)
    model = api.build_model(cfg)
    kind = api.SHAPE_CELLS[cell]["kind"]
    pstructs = model.param_structs(mesh)
    aux = dict(param_bytes=_tree_bytes(pstructs), n_params=model.n_params)
    batch = _blocks(model.input_specs(cell, mesh))

    if kind == "train":
        opt_cfg = adamw.AdamWConfig(state_bits=cfg.opt_state_bits)
        ostructs = train_loop.opt_state_structs(model, mesh, opt_cfg)
        aux["opt_bytes"] = _tree_bytes(ostructs)
        held = [_rank_bytes(pstructs), _rank_bytes(pstructs), _rank_bytes(ostructs)]  # masters, grads, moments
        step = train_loop.make_train_step(model, opt_cfg)

        def trace():
            step(_blocks(pstructs, True), _blocks(ostructs), batch)
    elif kind == "prefill":
        c = api.SHAPE_CELLS[cell]
        max_len = c["seq"] + cfg.meta_tokens
        sstructs = _serving_structs(model, mesh)
        held = [_rank_bytes(sstructs), _rank_bytes(_cache_structs(model, c["batch"], max_len, mesh))]

        def trace():
            with torch.no_grad():
                model.prefill(api.serving_weights(cfg, _blocks(sstructs)), batch, max_len)
    else:  # decode
        cache = model.cache_structs(cell, mesh)
        aux["cache_bytes"] = _tree_bytes(cache)
        sstructs = _serving_structs(model, mesh)
        held = [_rank_bytes(sstructs), _rank_bytes(cache)]
        has_kv = cfg.family in ("dense", "moe", "hybrid")
        seq_len = api.SHAPE_CELLS[cell]["seq"]

        def trace():
            from repro_torch.models import common as C

            with torch.no_grad(), ctx.use_mesh(mesh):
                c = _blocks(cache)
                if has_kv:
                    c["seq_blocks"] = C.seq_cut(seq_len)[0]
                model.decode_step(api.serving_weights(cfg, _blocks(sstructs)), c, batch["tokens"])
    aux["memory"] = dict(rank_bytes=sum(h for h, _ in held), spec_bytes=sum(s for _, s in held))
    return trace, aux


def _write(rec: dict, out_dir: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        slug = rec["arch"].replace(".", "p")
        with open(os.path.join(out_dir, f"dryrun_{slug}_{rec['cell']}_{rec['mesh']}.json"), "w") as f:
            json.dump(rec, f, indent=1)


def run_cell(arch_id: str, cell: str, multi_pod: bool, out_dir: str) -> dict:
    cfg = configs.get(arch_id)
    axes, shape = MESHES[multi_pod]
    mesh_name = "x".join(map(str, shape))
    rec: dict = {"arch": arch_id, "cell": cell, "mesh": mesh_name}
    skip = api.cell_skip_reason(cfg, cell)
    if skip:
        rec["status"] = "skip"
        rec["reason"] = skip
        _write(rec, out_dir)
        print(f"[SKIP] {arch_id} {cell} {mesh_name}: {skip}")
        return rec
    mesh = ctx.dry_mesh(axes, shape)
    try:
        with ctx.use_mesh(mesh):
            trace, aux = lower_cell(arch_id, cell, mesh)
            ctx.DRY_BYTES.clear()
            counter = FlopCounterMode(display=False)
            t0 = time.perf_counter()
            with counter:
                trace()
            trace_s = time.perf_counter() - t0
        rec.update(status="ok", trace_s=round(trace_s, 2), devices=mesh.size,
                   flops=float(counter.get_total_flops()), collective_bytes=dict(ctx.DRY_BYTES), **aux)
        rank = rec["memory"]["rank_bytes"]
        if rank > CARD_BYTES:
            rec["status"] = "fail"
            rec["error"] = (f"a rank holds {rank / 1e9:.1f} GB under the JAX spec, over the card's"
                            f" {CARD_BYTES / 1e9:.0f} GB")
        tag = "OK" if rec["status"] == "ok" else "FAIL"
        print(f"[{tag}] {arch_id:24s} {cell:12s} {mesh_name}: flops={rec['flops']:.3e} "
              f"rank={rank / 2**30:.2f}GiB spec={rec['memory']['spec_bytes'] / 2**30:.2f}GiB trace={rec['trace_s']}s")
    except Exception as e:  # noqa: BLE001 — a failing cell is a finding
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch_id} {cell} {mesh_name}: {rec['error'][:200]}")
    _write(rec, out_dir)
    return rec


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--cell", choices=list(api.SHAPE_CELLS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="benchmarks/artifacts")
    args = ap.parse_args(argv)

    cells = [args.cell] if args.cell else list(api.SHAPE_CELLS)
    archs = [args.arch] if args.arch else configs.ARCH_IDS
    if not (args.all or args.arch):
        ap.error("pass --arch or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = [run_cell(a, c, mp, args.out) for mp in meshes for a in archs for c in cells]
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skip" for r in results)
    fail = sum(r["status"] == "fail" for r in results)
    print(f"\n== dry-run summary: {ok} ok / {skip} skip / {fail} fail ==")
    if fail and argv is None:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
