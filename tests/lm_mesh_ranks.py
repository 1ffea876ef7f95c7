"""The rank program of tests/test_torch_lm_mesh.py: the package's LM mesh
job (``repro_torch.launch.lm_mesh_job``) and the tests' own steps.

* ``("grads_kept", {arch, smoke, overrides, seed, rows})``: the job's
  step-0 loss and reduced gradients, the gradients returned (this rank's
  blocks, as numpy).
* ``("moe", {cfg, p, x, impl, with_grads, aux_weight})``: ``moe_apply`` on
  the rank's rows of ``x`` (its block of positions where the sequence
  splits, as the stream holds it) with weights ``p`` (whole, cut here); its
  output (gathered whole along the sequence) and aux, and with
  ``with_grads`` the gradients of the global sum of squares of the output
  plus ``aux_weight`` times aux.
* ``("cp_decode", {q, k, v, cur})``: ``decode_attention_cp`` on the rank's
  sequence block of a cache.
* ``("shapes", {arch, smoke, overrides, prompts, max_len})``: the shapes of
  every leaf this rank holds: the serving weights, the masters, the 32-
  and 8-bit moments (``train.loop.init_state``) and the cache after a
  prefill of its rows of ``prompts``.
* ``("tp_block", {cfg, p, x})``: one dense block (``dense.block_train``) on
  the rank's blocks of the one-layer weights ``p`` and its rows and
  positions of ``x`` (the output gathered whole along the sequence),
  computed in float32 (bf16 replaced by float32 while it runs); its output
  and the reduced gradients of the global sum of squares of the output.
* ``("moments8", {arch, smoke, overrides, rows})``: one train step with
  8-bit moments from the seed-0 masters on the global ``rows``; the loss
  and every moment leaf (this rank's blocks).
* ``("psum_forms", {x})``: ``ctx.psum`` over both axes of ``x`` times
  (rank + 1), in float32 and bf16, as one all-gather and as a
  reduce-scatter and an all-gather (``ctx.SCATTER_SUM_BYTES``).
* ``("serve_carried", {arch, smoke, params, prompts, max_len})``: the
  serving weights carried across from a numpy tree (``params``, a ``.npz``
  path of ``name/with/slashes`` keys) by ``params.model_params_from_numpy``
  under the mesh, and the prefill logits of the rank's rows.
* ``("loss_carried", {arch, smoke, overrides, params, rows})``: the training masters
  carried across from a numpy tree by ``params.train_state_from_numpy``
  under the mesh, and the global ``rows``' loss.
* ``("vocab_gathers", {arch, smoke, overrides, prompts, max_len})``: every
  ``ctx.gather_dims`` call on a leaf of the embedding's or the head's shape
  during a prefill, a decode step and the step-0 loss and gradients, with
  the logical names of the dims it gathers (``ctx.gather_dims`` is looked
  up at each call, so a recording stand-in sees every one).
* ``("stream_shapes", {arch, smoke, prompts, max_len})``: the shapes of the
  stream entering every block (``common.STREAM``) in a prefill of the
  rank's rows, one decode step and the step-0 loss and gradients.
* ``("planted", {kind, op, **kw})``: the step ``op`` with ``kw`` while
  ``chip_smoke.mesh_fault(kind)`` plants one of the card phase's faults.
* ``("xent", {x, head, labels, mask, chunk})``: ``common.chunked_softmax_xent``
  on the rank's rows and block of positions of ``x`` and its block of the
  vocabulary of ``head``; the loss and the reduced gradients of ``x`` (the
  rank's rows) and of its block of ``head``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import params as tparams
from repro_torch.launch import lm_mesh_job as job
from repro_torch.models import api
from repro_torch.models import common as C
from repro_torch.models import dense
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as PM
from repro_torch.optim import adamw
from repro_torch.sharding import ctx
from repro_torch.train import loop as tl


def grads_kept(mesh, arch, smoke=False, overrides=None, seed=0, rows=None) -> dict:
    _, names, gl, out = job.step0_grads(mesh, arch, smoke, overrides, seed, rows)
    out["grads"] = {n: job._np(g) for n, g in zip(names, gl)}
    return out


def moe(mesh, cfg, p, x, impl="gather", with_grads=False, aux_weight=1.0) -> dict:
    cfg = dataclasses.replace(cfg, moe_impl=impl)
    dev = mesh.device
    x = np.asarray(x)
    defs = moe_mod.layer_defs(cfg)
    shp = {k: PM.sharding_of(defs[k], mesh) for k in ("router", "e_gate", "e_up", "e_down")}
    pp = {k: torch.as_tensor(np.array(shp[k].block(np.asarray(v))), device=dev).requires_grad_(with_grads)
          for k, v in p.items()}
    xb = torch.as_tensor(np.array(ctx.sharding_for(mesh, ("batch", None, None), x.shape).block(x)), device=dev)
    xb.requires_grad_(with_grads)
    with torch.set_grad_enabled(with_grads):
        seq = ctx.seq_split(x.shape[1])
        out, aux = moe_mod.moe_apply(pp, ctx.constrain(xb, "batch", "seq", None), cfg, seq)
        out = C.gather_seq(out, seq)
        res = {"out": job._np(out), "aux": float(aux)}
        if with_grads:
            # the loss every rank computes alike: the global batch's sum, plus aux
            tot = ctx.psum(mesh, ctx.batch_axes(mesh), (out.float() ** 2).sum()) + aux_weight * aux
            gs = torch.autograd.grad(tot / mesh.size, [xb] + [pp[k] for k in sorted(pp)])
            for k, g in zip(sorted(pp), gs[1:]):
                split = tuple(a for a in mesh.axis_names if a not in shp[k].axes())
                ctx.all_reduce_(mesh, split, g)
            # x's rows are this rank's: sum over the axes that replicate them
            ctx.all_reduce_(mesh, tuple(a for a in mesh.axis_names if a not in ctx.batch_axes(mesh)), gs[0])
            res["grads"] = {"x": job._np(gs[0]), **{k: job._np(g) for k, g in zip(sorted(pp), gs[1:])}}
    return res


def cp_decode(mesh, q, k, v, cur) -> dict:
    dev = mesh.device
    k = np.asarray(k)
    blocks, block = C.seq_cut(k.shape[1])
    s_loc = k.shape[1] // blocks
    kb = torch.as_tensor(k[:, block * s_loc : (block + 1) * s_loc], device=dev)
    vb = torch.as_tensor(np.asarray(v)[:, block * s_loc : (block + 1) * s_loc], device=dev)
    out = C.decode_attention_cp(torch.as_tensor(np.asarray(q), device=dev), kb, vb,
                                torch.as_tensor(np.asarray(cur), device=dev), blocks)
    return {"out": job._np(out), "blocks": blocks}


def leaf_shapes(tree, prefix: str = "") -> dict:
    """``name -> shape`` of every tensor of nested dicts (an 8-bit moment's
    ``q`` and ``s`` apart), keys sorted; other values left out."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(leaf_shapes(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def _rows_of(mesh, rows):
    rows = np.asarray(rows)
    block = ctx.sharding_for(mesh, ("batch", None), rows.shape).block(rows)
    return torch.as_tensor(np.array(block), device=mesh.device)


def shapes(mesh, arch, smoke=True, overrides=None, prompts=None, max_len=None) -> dict:
    cfg = job._cfg(arch, smoke, overrides)
    model = api.build_model(cfg)
    dev = mesh.device
    lm = model.init(0, dev)
    out = {"params": {n.replace(".", "/"): tuple(t.shape) for n, t in lm.named_parameters()}}
    masters = model.init_masters(0, dev)
    out["masters"] = leaf_shapes(masters)
    for bits in (32, 8):
        st = tl.init_state(model, masters, adamw.AdamWConfig(state_bits=bits))
        out[f"moments{bits}"] = leaf_shapes({"m": st.m, "v": st.v})
    with torch.no_grad():
        _, cache = model.prefill(lm, {"tokens": _rows_of(mesh, prompts)}, max_len)
    out["cache"] = leaf_shapes(cache)
    return out


def tp_block(mesh, cfg, p, x) -> dict:
    saved = C.COMPUTE_DTYPE
    C.COMPUTE_DTYPE = torch.float32
    try:
        defs = dense.layer_defs(cfg)
        pp = {k: torch.as_tensor(np.array(PM.sharding_of(defs[k], mesh).block(np.asarray(v))),
                                 device=mesh.device).requires_grad_() for k, v in p.items()}
        x = np.asarray(x)
        xb = torch.as_tensor(np.array(ctx.sharding_for(mesh, ("batch", None, None), x.shape).block(x)),
                             device=mesh.device).requires_grad_()
        with torch.enable_grad():
            y = dense.block_train(cfg, pp, ctx.constrain(xb, "batch", "seq", None),
                                  torch.arange(x.shape[1], device=mesh.device))
            y = C.gather_seq(y, ctx.seq_split(x.shape[1]))
            tot = ctx.psum(mesh, ctx.batch_axes(mesh), (y.float() ** 2).sum())
            gs = torch.autograd.grad(tot / mesh.size, [xb] + [pp[k] for k in sorted(pp)])
        for k, g in zip(sorted(pp), gs[1:]):
            split = PM.sharding_of(defs[k], mesh).axes()
            ctx.all_reduce_(mesh, tuple(a for a in mesh.axis_names if a not in split), g)
        ctx.all_reduce_(mesh, tuple(a for a in mesh.axis_names if a not in ctx.batch_axes(mesh)), gs[0])
        return {"out": job._np(y), "attn_axes": dense.attn_axes(cfg), "ffn_axes": dense.ffn_axes(cfg),
                "grads": {"x": job._np(gs[0]), **{k: job._np(g) for k, g in zip(sorted(pp), gs[1:])}}}
    finally:
        C.COMPUTE_DTYPE = saved


def moments8(mesh, arch, smoke=True, overrides=None, rows=None) -> dict:
    cfg = job._cfg(arch, smoke, overrides)
    model = api.build_model(cfg)
    opt = adamw.AdamWConfig(state_bits=8, warmup_steps=1, total_steps=2)
    params = model.init_masters(0, mesh.device)
    state = tl.init_state(model, params, opt)
    params, state, m = tl.make_train_step(model, opt)(params, state, {"tokens": _rows_of(mesh, rows)})

    def host(tree):
        return {k: host(v) if isinstance(v, dict) else job._np(v) for k, v in tree.items()}

    return {"loss": float(m["loss"]), "m": host(state.m), "v": host(state.v)}


def psum_forms(mesh, x) -> dict:
    saved, out = ctx.SCATTER_SUM_BYTES, {}
    try:
        for dt in (torch.float32, torch.bfloat16):
            t = (torch.as_tensor(np.asarray(x), device=mesh.device) * (mesh.rank + 1)).to(dt)
            for form, limit in (("gather", 1 << 62), ("scatter", 0)):
                ctx.SCATTER_SUM_BYTES = limit
                out[f"{form}_{str(dt)[6:]}"] = job._np(ctx.psum(mesh, ("data", "model"), t))
    finally:
        ctx.SCATTER_SUM_BYTES = saved
    return out


def _npz_tree(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as f:
        for name in f.files:
            node = tree
            *keys, leaf = name.split("/")
            for k in keys:
                node = node.setdefault(k, {})
            node[leaf] = f[name]
    return tree


def serve_carried(mesh, arch, smoke=True, params=None, prompts=None, max_len=None) -> dict:
    cfg = job._cfg(arch, smoke)
    lm = tparams.model_params_from_numpy(cfg, _npz_tree(params), mesh.device)
    prompts = np.asarray(prompts)
    rows = ctx.sharding_for(mesh, ("batch", None), prompts.shape)
    with torch.no_grad():
        logits, _ = api.build_model(cfg).prefill(lm, {"tokens": _rows_of(mesh, prompts)}, max_len)
    return {"rows": [int(i) for i in job._row_range(rows, prompts.shape[0])], "logits": job._np(logits),
            "held": {n.replace(".", "/"): tuple(t.shape) for n, t in lm.named_parameters()}}


def loss_carried(mesh, arch, smoke=True, overrides=None, params=None, rows=None) -> dict:
    cfg = job._cfg(arch, smoke, overrides)
    masters, _ = tparams.train_state_from_numpy(cfg, _npz_tree(params), device=mesh.device)
    with torch.no_grad():
        loss = api.build_model(cfg).loss_fn(masters, {"tokens": _rows_of(mesh, rows)})
    return {"loss": float(loss)}


def _serve_and_grads(mesh, model, prompts, max_len) -> dict:
    """A prefill of the rank's rows of ``prompts``, one greedy decode step,
    then the step-0 loss and gradients of the masters on the same rows ->
    the shapes of the stream entering the blocks of each (``common.STREAM``)."""
    rows = _rows_of(mesh, prompts)
    noted, out = {}, {}

    def phase(name, fn):
        C.STREAM = []
        try:
            fn()
        finally:
            noted[name], C.STREAM = sorted({shape for shape, _ in C.STREAM}), None

    lm = model.init(0, mesh.device)
    with torch.no_grad():
        phase("prefill", lambda: out.update(zip(("logits", "cache"), model.prefill(lm, {"tokens": rows}, max_len))))
        nxt = torch.argmax(out["logits"], -1).to(torch.int32)[:, None]
        phase("decode", lambda: model.decode_step(lm, out["cache"], nxt))
    masters = model.init_masters(0, mesh.device)
    phase("loss", lambda: tl._value_and_grad(model, masters, {"tokens": rows}))
    return noted


def vocab_gathers(mesh, arch, smoke=True, overrides=None, prompts=None, max_len=None) -> dict:
    cfg = job._cfg(arch, smoke, overrides)
    shapes = {(cfg.vocab, cfg.d_model): "embed", (cfg.d_model, cfg.vocab): "lm_head"}
    calls, saved = [], ctx.gather_dims

    def recording(x, logical, shape, names=("fsdp", "tensor"), dtype=None):
        if tuple(shape) in shapes:
            dims = [logical[d] for _, d in ctx._named_cuts(mesh, tuple(logical), tuple(shape), names)]
            calls.append((shapes[tuple(shape)], dims))
        return saved(x, logical, shape, names, dtype)

    ctx.gather_dims = recording
    try:
        _serve_and_grads(mesh, api.build_model(cfg), prompts, max_len)
    finally:
        ctx.gather_dims = saved
    return {"calls": calls, "vocab_axes": dense.vocab_axes(cfg)}


def stream_shapes(mesh, arch, smoke=True, prompts=None, max_len=None) -> dict:
    return _serve_and_grads(mesh, api.build_model(job._cfg(arch, smoke)), prompts, max_len)


def xent(mesh, x, head, labels, mask, chunk=16) -> dict:
    x, head, labels, mask = (np.asarray(a) for a in (x, head, labels, mask))
    rows = ctx.sharding_for(mesh, ("batch", None), labels.shape)
    cols = ctx.sharding_for(mesh, (None, "tensor"), head.shape)
    dev = mesh.device
    xb = torch.as_tensor(np.array(rows.block(x)), device=dev).requires_grad_()
    hb = torch.as_tensor(np.array(cols.block(head)), device=dev).requires_grad_()
    seq = ctx.seq_split(x.shape[1])
    with torch.enable_grad():
        loss = C.chunked_softmax_xent(ctx.constrain(xb, "batch", "seq", None), hb,
                                      torch.as_tensor(np.array(rows.block(labels)), device=dev),
                                      torch.as_tensor(np.array(rows.block(mask)), device=dev), chunk,
                                      ctx._live(mesh, cols.spec[1]), seq)
        gx, gh = torch.autograd.grad(loss / mesh.size, [xb, hb])
    ctx.all_reduce_(mesh, tuple(a for a in mesh.axis_names if a not in ctx.batch_axes(mesh)), gx)
    ctx.all_reduce_(mesh, tuple(a for a in mesh.axis_names if a not in cols.axes()), gh)
    return {"rows": [int(i) for i in job._row_range(rows, labels.shape[0])], "loss": float(loss),
            "grads": {"x": job._np(gx), "head": job._np(gh)}}


def planted(mesh, kind, op, **kw) -> dict:
    import chip_smoke  # the repository's root is on the ranks' path (pytest's rootdir)

    with chip_smoke.mesh_fault(kind):
        return OPS[op](mesh, **kw)


OPS = dict(job.OPS, planted=planted, grads_kept=grads_kept, moe=moe, cp_decode=cp_decode, shapes=shapes,
           tp_block=tp_block, moments8=moments8, psum_forms=psum_forms, serve_carried=serve_carried,
           loss_carried=loss_carried, vocab_gathers=vocab_gathers, stream_shapes=stream_shapes, xent=xent)


def run(j: job.LMMeshJob) -> dict:
    return job.run(j, OPS)
