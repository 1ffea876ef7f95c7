"""The rank program of tests/test_torch_lm_mesh.py: the package's LM mesh
job (``repro_torch.launch.lm_mesh_job``) and three steps of the tests' own.

* ``("grads_kept", {arch, smoke, overrides, seed, rows})``: the job's
  step-0 loss and reduced gradients, the gradients returned (this rank's
  blocks, as numpy).
* ``("moe", {cfg, p, x, impl, with_grads, aux_weight})``: ``moe_apply`` on
  the rank's rows of ``x`` with weights ``p`` (whole, cut here); its output
  and aux, and with ``with_grads`` the gradients of the global sum of
  squares of the output plus ``aux_weight`` times aux.
* ``("cp_decode", {q, k, v, cur})``: ``decode_attention_cp`` on the rank's
  sequence block of a cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.launch import lm_mesh_job as job
from repro_torch.models import common as C
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as PM
from repro_torch.sharding import ctx


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
        out, aux = moe_mod.moe_apply(pp, xb, cfg)
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


OPS = dict(job.OPS, grads_kept=grads_kept, moe=moe, cp_decode=cp_decode)


def run(j: job.LMMeshJob) -> dict:
    return job.run(j, OPS)
