"""Parameter declarations and their initialisation.

Counterpart of ``repro.models.params`` without the logical sharding axes:
a model declares a nested dict of :class:`PDef` (shape, init rule, storage
dtype), and one tree gives the parameter count and the initialised
tensors. :func:`init_params` follows the JAX package's init rules (normal
with a fan-in scale, ``embed`` x0.02, ones, zeros) but draws from a
``torch.Generator``, so its numbers differ from ``jax.random``'s; tests
that need the same weights in both packages carry the JAX tree across
(``repro_torch.params.model_params_from_numpy``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class PDef(NamedTuple):
    shape: tuple
    init: str = "normal"  # normal | zeros | ones | embed
    dtype: torch.dtype = torch.float32  # storage dtype
    scale: float | None = None  # override fan-in scale


def _leaves(defs: dict, prefix: tuple = ()):
    for name, p in defs.items():
        if isinstance(p, PDef):
            yield prefix + (name,), p
        else:
            yield from _leaves(p, prefix + (name,))


def stack(defs: dict, n: int) -> dict:
    """Prepend a layer dimension of size ``n`` to every leaf."""
    return {
        name: stack(p, n) if isinstance(p, dict) else p._replace(shape=(n,) + p.shape)
        for name, p in defs.items()
    }


def _init_leaf(p: PDef, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=dev)
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32, device=dev)
    if p.init == "embed":
        return x.mul_(0.02).to(p.dtype)
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    scale = p.scale if p.scale is not None else 1.0 / (fan_in**0.5)
    return x.mul_(scale).to(p.dtype)


def init_params(defs: dict, gen: torch.Generator) -> dict:
    """A tree of tensors on ``gen``'s device, one draw per leaf in
    declaration order, each cast to its storage dtype as it is drawn."""
    out: dict = {}
    for path, p in _leaves(defs):
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = _init_leaf(p, gen)
    return out


def count_params(defs: dict) -> int:
    return sum(math.prod(p.shape) for _, p in _leaves(defs))
