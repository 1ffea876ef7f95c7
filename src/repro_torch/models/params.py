"""Parameter declarations and their initialisation.

Counterpart of ``repro.models.params``: a model declares a nested dict of
:class:`PDef` (shape, init rule, storage dtype, logical sharding axes),
and one tree gives the parameter count, the initialised tensors, the
specs on the ambient mesh (:func:`param_specs`) and the allocation-free
structs of the dry-run (:func:`param_structs`). ``logical`` is the last
field here (the JAX package's second), so a declaration without it keeps
its meaning. :func:`init_params` follows the JAX package's init rules (normal
with a fan-in scale, ``embed`` x0.02, ones, zeros) but draws from a
``torch.Generator``, so its numbers differ from ``jax.random``'s; tests
that need the same weights in both packages carry the JAX tree across
(``repro_torch.params.model_params_from_numpy``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.sharding import ctx


class PDef(NamedTuple):
    shape: tuple
    init: str = "normal"  # normal | zeros | ones | embed
    dtype: torch.dtype = torch.float32  # storage dtype
    scale: float | None = None  # override fan-in scale
    logical: tuple | None = None  # logical sharding axis per dim (None = replicated)

    @property
    def axes(self) -> tuple:
        """``logical``, or every dim replicated."""
        return self.logical if self.logical is not None else (None,) * len(self.shape)


def _leaves(defs: dict, prefix: tuple = ()):
    for name, p in defs.items():
        if isinstance(p, PDef):
            yield prefix + (name,), p
        else:
            yield from _leaves(p, prefix + (name,))


def stack(defs: dict, n: int) -> dict:
    """Prepend a layer dimension of size ``n`` to every leaf."""
    return {
        name: stack(p, n) if isinstance(p, dict) else p._replace(shape=(n,) + p.shape, logical=(None,) + p.axes)
        for name, p in defs.items()
    }


def param_dtype_defs(defs: dict, param_dtype: str) -> dict:
    """``defs`` with every float32 leaf cast to ``param_dtype`` (a torch
    dtype's name, ``"float32"`` or ``"bfloat16"``), as the JAX package's
    ``build_model`` casts its defs."""
    pd = getattr(torch, param_dtype)
    return {
        k: param_dtype_defs(p, param_dtype) if isinstance(p, dict)
        else p._replace(dtype=pd) if p.dtype == torch.float32 else p
        for k, p in defs.items()
    }


# A leaf of more elements than this is drawn one row of its leading dim
# (a layer of a stacked leaf) at a time, each row cast to the storage dtype
# as it is drawn: qwen3-32b's stacked MLP leaves are 33.5 GB in float32, which
# one card cannot hold beside the rest of its 65.5 GB of bf16 weights. Every
# smaller leaf is one draw; the bound lies above the largest leaf any other
# served or trained model draws (phi3.5-moe's 8-layer expert stack, 3.4 B
# elements), whose numbers a draw in rows would change.
DRAW_WHOLE_MAX = 1 << 32


def _init_leaf(p: PDef, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=dev)
    if p.init == "embed":
        scale = 0.02
    else:
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = p.scale if p.scale is not None else 1.0 / (fan_in**0.5)

    def draw(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).mul_(scale).to(p.dtype)

    if math.prod(p.shape) <= DRAW_WHOLE_MAX:
        return draw(p.shape)
    out = torch.empty(p.shape, dtype=p.dtype, device=dev)
    for row in out:
        row.copy_(draw(p.shape[1:]))
    return out


def init_params(defs: dict, gen: torch.Generator, keep=None) -> dict:
    """A tree of tensors on ``gen``'s device, one draw per leaf in
    declaration order, each cast to its storage dtype as it is drawn.
    ``keep(p, t)``, where given, maps each drawn leaf to what the tree holds
    (a rank's block under the JAX spec on a mesh, :func:`sharding_of`)
    before the next leaf is drawn, so the peak is one whole leaf."""
    out: dict = {}
    for path, p in _leaves(defs):
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = _init_leaf(p, gen) if keep is None else keep(p, _init_leaf(p, gen))
    return out


def tree_map(fn, defs: dict) -> dict:
    """``fn`` over every :class:`PDef` of ``defs``, the nesting kept."""
    return {k: tree_map(fn, p) if isinstance(p, dict) else fn(p) for k, p in defs.items()}


def param_specs(defs: dict) -> dict:
    """The JAX package's spec of every leaf on the ambient mesh (``()``
    without one)."""
    return tree_map(lambda p: ctx.spec_for(p.shape, *p.axes), defs)


def sharding_of(p: PDef, mesh) -> ctx.NamedSharding:
    """The leaf's :class:`~repro_torch.sharding.ctx.NamedSharding` on
    ``mesh``: the JAX package's spec, whose block a rank holds."""
    return ctx.sharding_for(mesh, p.axes, p.shape)


def struct(shape, dtype, sharding=None) -> torch.Tensor:
    """A ``meta`` tensor standing for an array (``jax.ShapeDtypeStruct``),
    with its ``sharding`` attribute (None without a mesh)."""
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    t.sharding = sharding
    return t


def param_structs(defs: dict, mesh=None) -> dict:
    """A meta tensor of every leaf's global shape and dtype, each with its
    ``NamedSharding`` on ``mesh`` (or the ambient one), for the dry-run."""
    mesh = mesh or ctx.get_mesh()
    return tree_map(lambda p: struct(p.shape, p.dtype, None if mesh is None else sharding_of(p, mesh)), defs)


def block_bytes(tree) -> int:
    """The bytes of this rank's blocks of a tree of structs (dicts and
    tuples of :func:`struct`) under their shardings."""
    if isinstance(tree, dict):
        return sum(block_bytes(t) for t in tree.values())
    if isinstance(tree, tuple):
        return sum(block_bytes(t) for t in tree)
    return math.prod(tree.sharding.block_shape(tree.shape)) * tree.element_size()


def count_params(defs: dict) -> int:
    return sum(math.prod(p.shape) for _, p in _leaves(defs))
