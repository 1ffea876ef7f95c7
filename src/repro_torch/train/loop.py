"""Train-step builder: microbatched gradient accumulation, clipping, AdamW,
optional int8 gradient compression (the counterpart of
``repro.train.loop``), on one device or data- and expert-parallel under
an ambient mesh (``sharding.ctx.use_mesh``, looked up at each call).

Under a mesh each rank holds its blocks of the masters, of their
gradients and of the moments under the JAX spec (``sharding.ctx``: the
expert stacks over the expert axes, every ``fsdp`` and ``tensor`` dim
over theirs) and its block of the batch rows, and the step is GSPMD's
data parallelism with ZeRO: every rank computes the global batch's loss
(``common.chunked_softmax_xent`` sums the numerator and the token count
over the batch axes; the ranks of a ``model`` line, each holding its
block of positions of the stream and of the vocabulary, get the same
loss through its sums over ``tensor``, so the loss is replicated over
every axis but the batch's and the rule below holds as it is), takes the gradient of ``loss / mesh.size`` through
the collectives' transposes (a weight's gather before use reduce-scatters
its gradient over the axes it was gathered over, in float32), and sums
each leaf's gradient over the mesh axes the leaf is neither split nor
gathered over (float32 on the wire; :func:`mesh_grads`). The clipping
norm is the whole tree's: a block's squares are summed over the axes that
split it, a replicated leaf counts once. 8-bit moments follow the layout
:func:`opt_state_structs` gives (:func:`init_state`): quantized along the
axis ``adamw.quant_axis`` picks for the leaf's global shape, the block
scales split as the leaf except along that axis when the rank's block
there holds no whole number of quantization blocks; such a leaf's moments
are gathered along that axis for the update (:func:`quant_lines`), so a
block's moments are always the matching block of the whole leaf's.
With microbatches, microbatch i is the union of the ranks' i-th slices of
their blocks.

``make_train_step(model, opt_cfg)`` returns ``step(params, opt_state,
batch) -> (params, opt_state, metrics)``; with ``compress=True``,
``step(params, opt_state, ef, batch) -> (params, opt_state, ef,
metrics)``. ``params`` are the model's training masters
(``model.init_masters``) and are updated in place; ``metrics`` holds the
``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the device, read
without a host sync until the caller asks.
"""
from __future__ import annotations

import torch

import math

from repro_torch.models import params as PM
from repro_torch.optim import adamw
from repro_torch.runtime import compress as gc
from repro_torch.sharding import ctx


def _split_microbatches(batch: dict, m: int) -> list[dict]:
    """``batch`` as ``m`` microbatches along the leading axis, in order."""
    def sp(x):
        x = torch.as_tensor(x)
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch of {b} does not split into {m} microbatches")
        return x.reshape((m, b // m) + tuple(x.shape[1:]))

    split = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(m)]


_leaves = adamw._leaves  # dict keys sorted, as jax.tree orders them


def _unflatten(tree: dict, it) -> dict:
    return {k: _unflatten(tree[k], it) if isinstance(tree[k], dict) else next(it) for k in sorted(tree)}


def _value_and_grad(model, params: dict, batch: dict, scale: float = 1.0) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The loss and the gradient of ``scale`` times it for every master
    leaf; a leaf the loss never reads (hubert's ``embed``) gets zeros, as
    ``jax.grad`` gives it."""
    leaves = _leaves(params)
    with torch.enable_grad():
        loss = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss * scale if scale != 1.0 else loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]


def _def_leaves(defs: dict) -> list:
    """The :class:`~repro_torch.models.params.PDef` leaves of ``defs`` in
    the masters' leaf order (keys sorted)."""
    return [d for k in sorted(defs) for d in (_def_leaves(defs[k]) if isinstance(defs[k], dict) else [defs[k]])]


def mesh_grads(mesh, model, grads: list[torch.Tensor]) -> torch.Tensor:
    """Sum each gradient over the mesh axes its leaf is replicated on, in
    place -> the whole tree's gradient norm (:func:`mesh_grads_norm`). The
    axes that split a leaf are left out: its gather before use already
    reduce-scattered its gradient over them (ZeRO)."""
    for g, p in zip(grads, _def_leaves(model.defs)):
        split = PM.sharding_of(p, mesh).axes()
        ctx.all_reduce_(mesh, tuple(a for a in mesh.axis_names if a not in split), g)
    return mesh_grads_norm(mesh, model, grads)


def mesh_grads_norm(mesh, model, grads: list[torch.Tensor]) -> torch.Tensor:
    """The whole tree's norm of reduced gradients, float32, the same on
    every rank: a block's squares summed over the axes that split it, a
    replicated leaf's counted once."""
    sq_split, sq_whole = {}, torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g, p in zip(grads, _def_leaves(model.defs)):
        split = PM.sharding_of(p, mesh).axes()
        sq = torch.sum(torch.square(g.float()))
        if split:
            sq_split[split] = sq_split.get(split, 0.0) + sq
        else:
            sq_whole = sq_whole + sq
    for axes, sq in sq_split.items():
        sq_whole = sq_whole + ctx.psum(mesh, axes, sq)
    return torch.sqrt(sq_whole)


def _line(mesh, axes: tuple, axis: int) -> tuple:
    return (axis, lambda t: ctx.all_gather_tiled(mesh, axes, t, axis),
            lambda t: ctx.block_along(mesh, axes, t, axis))


def quant_lines(mesh, model, params: dict, opt_cfg: adamw.AdamWConfig) -> list | None:
    """Per master leaf (``adamw.update``'s ``lines``): None where the rank's
    block holds whole q_blocks along the global quantization axis of the
    leaf (or of its layer slice), else ``(axis, widen, narrow)``: the
    all-gather of a moment along that axis over the mesh axes splitting it
    and the rank's block of the result. Those blocks' scales are whole
    along the axis (:func:`opt_state_structs`), as the JAX layout has
    them. None for 32-bit moments."""
    if opt_cfg.state_bits != 8:
        return None
    out = []
    for p, d in zip(_leaves(params), _def_leaves(model.defs)):
        sliced = int(p.dim() >= 3 and p.shape[0] <= 512)  # adamw.update's layer slices
        ax = adamw.quant_axis(tuple(d.shape[sliced:]), opt_cfg.q_block)
        if ax is None or p.shape[ax + sliced] % opt_cfg.q_block == 0:
            out.append(None)
            continue
        spec = PM.sharding_of(d, mesh).spec
        axes = spec[ax + sliced] if ax + sliced < len(spec) else None
        out.append(_line(mesh, (axes,) if isinstance(axes, str) else tuple(axes), ax))
    return out


def init_state(model, params: dict, opt_cfg: adamw.AdamWConfig) -> adamw.AdamWState:
    """``adamw.init``; under a mesh, zeros of this rank's blocks of the
    layout :func:`opt_state_structs` gives, on the masters' device."""
    mesh = ctx.get_mesh()
    if mesh is None:
        return adamw.init(params, opt_cfg)
    dev = _leaves(params)[0].device
    structs = opt_state_structs(model, mesh, opt_cfg)

    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        return torch.zeros(t.sharding.block_shape(t.shape), dtype=t.dtype, device=dev)

    return adamw.AdamWState(zeros(structs.m), zeros(structs.v), torch.zeros((), dtype=torch.int32, device=dev))


def _norm_kw(gnorm) -> dict:
    """The clipping norm for ``adamw.update``: the whole tree's under a mesh,
    else computed there (the one-process call stays the plain one)."""
    return {} if gnorm is None else {"grad_norm": gnorm}


def make_train_step(model, opt_cfg: adamw.AdamWConfig, compress: bool = False):
    """Returns step(params, opt_state, [ef_state,] batch) -> (..., metrics)."""

    def grads_of(params: dict, batch: dict, scale: float) -> tuple[torch.Tensor, list]:
        m = model.cfg.microbatches
        if m == 1:
            return _value_and_grad(model, params, batch, scale)
        acc_dtype = getattr(torch, model.cfg.grad_accum_dtype)
        loss_sum, g_sum = 0.0, [torch.zeros(p.shape, dtype=acc_dtype, device=p.device) for p in _leaves(params)]
        for mbatch in _split_microbatches(batch, m):  # the scan's order
            loss, g = _value_and_grad(model, params, mbatch, scale)
            loss_sum = loss_sum + loss
            g_sum = [(a + b.to(acc_dtype)).to(acc_dtype) for a, b in zip(g_sum, g)]
        return loss_sum / m, [(g / m).to(acc_dtype) for g in g_sum]

    def grads_and_norm(params: dict, batch: dict):
        mesh = ctx.get_mesh()
        if mesh is None:
            loss, grads = grads_of(params, batch, 1.0)
            return loss, _unflatten(params, iter(grads)), None
        loss, grads = grads_of(params, batch, 1.0 / mesh.size)
        gnorm = mesh_grads(mesh, model, grads)
        return loss, _unflatten(params, iter(grads)), gnorm

    def update(params, grads, opt_state, gnorm):
        mesh = ctx.get_mesh()
        lines = None if mesh is None else quant_lines(mesh, model, params, opt_cfg)
        kw = _norm_kw(gnorm) if lines is None else dict(_norm_kw(gnorm), lines=lines)
        return adamw.update(opt_cfg, grads, opt_state, params, **kw)

    if compress:

        def step(params, opt_state, ef, batch):
            loss, grads, gnorm = grads_and_norm(params, batch)
            grads, ef = gc.compress_grads(grads, ef)
            if gnorm is not None:  # the compressed gradients' norm, over the whole tree
                gnorm = mesh_grads_norm(ctx.get_mesh(), model, _leaves(grads))
            params, opt_state, metrics = update(params, grads, opt_state, gnorm)
            return params, opt_state, ef, dict(metrics, loss=loss)

        return step

    def step(params, opt_state, batch):
        loss, grads, gnorm = grads_and_norm(params, batch)
        params, opt_state, metrics = update(params, grads, opt_state, gnorm)
        return params, opt_state, dict(metrics, loss=loss)

    return step


def opt_state_structs(model, mesh=None, opt_cfg: adamw.AdamWConfig | None = None) -> adamw.AdamWState:
    """The optimizer state as structs (``models.params.struct``), sharded
    like the params, for the dry-run: float32 moments, or with 8-bit
    moments int8/uint8 ``q`` and float32 block scales ``s``, whose spec
    drops a mesh axis that no longer divides the shrunken dim (the JAX
    package's ``opt_state_structs``)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(state_bits=getattr(model.cfg, "opt_state_bits", 32))
    mesh = mesh or ctx.get_mesh()
    pstructs = model.param_structs(mesh)

    def moment_like(s, signed: bool):
        sh = s.sharding
        ax = adamw.quant_axis(tuple(s.shape), opt_cfg.q_block) if opt_cfg.state_bits == 8 else None
        if ax is None:
            return PM.struct(s.shape, torch.float32, sh)
        sshape = tuple(s.shape[:ax]) + (s.shape[ax] // opt_cfg.q_block,) + tuple(s.shape[ax + 1:])
        ssh = sh
        if sh is not None:
            def cut(spec):
                spec = list(spec) + [None] * (len(s.shape) - len(spec))
                names = spec[ax]
                if names is not None:
                    names = (names,) if isinstance(names, str) else tuple(names)
                    if sshape[ax] % math.prod(sh.mesh.shape[n] for n in names):
                        spec[ax] = None
                return tuple(spec)

            ssh = ctx.NamedSharding(sh.mesh, cut(sh.spec))
        return {"q": PM.struct(s.shape, torch.int8 if signed else torch.uint8, sh),
                "s": PM.struct(sshape, torch.float32, ssh)}

    def tree(signed):
        return adamw._tree_map(lambda s: moment_like(s, signed), pstructs)

    return adamw.AdamWState(tree(True), tree(False),
                            PM.struct((), torch.int32, None if mesh is None else ctx.NamedSharding(mesh, ())))
