"""Carry hash parameters and indices across from numpy.

JAX and PyTorch cannot draw the same numbers from one seed, so the tests —
and ``api.build(..., params=...)`` — take a hash family as numpy arrays
(for instance the JAX package's ``make_family`` output) and turn it into
the port's parameter types; a quantized payload crosses the same way, so
both packages can run the payload tail on the same rows, and so does an
LM's parameter tree (every family), so both packages compute with the same
weights, and an LM's training state (master weights and AdamW moments).
Unsigned 32-bit values (salts, keys) become int64 holding the same values;
:func:`index_to_numpy` goes the other way, for a checkpoint both packages
read.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import hashing, pipeline, tables
from repro_torch.models import api as model_api
from repro_torch.models import dense
from repro_torch.optim import adamw
from repro_torch.runtime import payload as payload_mod


def _fields(obj: Any) -> Mapping[str, Any]:
    return obj._asdict() if hasattr(obj, "_asdict") else obj


def _t(a, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a restored block, already widened
        return a.to(device=device, dtype=dtype)
    arr = np.array(a)  # a writable copy
    if dtype == torch.int64:
        arr = arr.astype(np.int64)  # uint32 values, widened
    return torch.as_tensor(arr, device=device).to(dtype)


def from_jax_params(
    outer: Mapping[str, np.ndarray],
    inner: Mapping[str, np.ndarray],
    device: torch.device | str | None = None,
) -> tuple[hashing.BitSampleParams, hashing.SignRPParams]:
    """``outer`` {dims, thrs, salts} and ``inner`` {proj, salts} arrays (or
    NamedTuples with those fields) -> the port's parameter pair on
    ``device`` (the card unless told otherwise)."""
    device = device_mod.resolve(device)
    o, i = _fields(outer), _fields(inner)
    dims = _t(o["dims"], torch.int32, device)
    d = int(np.shape(i["proj"])[1])
    if dims.numel() and not (0 <= int(dims.min()) and int(dims.max()) < d):
        raise ValueError(f"bit-sampling dims must lie in [0, {d})")
    return (
        hashing.BitSampleParams(
            dims, _t(o["thrs"], torch.float32, device), _t(o["salts"], torch.int64, device)
        ),
        hashing.SignRPParams(
            _t(i["proj"], torch.float32, device), _t(i["salts"], torch.int64, device)
        ),
    )


def index_from_numpy(ix: Any, device: torch.device | str | None = None) -> pipeline.SLSHIndex:
    """An ``SLSHIndex`` from any object with the same leaves (for instance
    the JAX package's index, read through ``np.asarray``, or restored
    tensors), on ``device`` (the card unless told otherwise)."""
    device = device_mod.resolve(device)
    outer, inner = from_jax_params(ix.outer_params, ix.inner_params, device)
    hv = ix.heavy
    return pipeline.SLSHIndex(
        outer,
        inner,
        tables.TableSet(
            _t(ix.outer.sorted_keys, torch.int64, device),
            _t(ix.outer.sorted_idx, torch.int32, device),
        ),
        tables.HeavyBuckets(
            _t(hv.keys, torch.int64, device),
            _t(hv.start, torch.int32, device),
            _t(hv.size, torch.int32, device),
            _t(hv.valid, torch.bool, device),
            _t(hv.overflowed, torch.int32, device),
        ),
        _t(ix.inner_keys, torch.int64, device),
        _t(ix.inner_idx, torch.int32, device),
        int(ix.n),
    )


def u32(t: torch.Tensor) -> np.ndarray:
    """An int64 tensor of unsigned 32-bit values (keys, salts) as the
    ``uint32`` array the JAX package holds; refuses values outside
    ``[0, 2**32)``."""
    a = t.detach().cpu().numpy()
    if a.size and (int(a.min()) < 0 or int(a.max()) >= 1 << 32):
        raise ValueError("32-bit key values must lie in [0, 2**32)")
    return a.astype(np.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def family_to_numpy(
    outer: hashing.BitSampleParams, inner: hashing.SignRPParams
) -> tuple[hashing.BitSampleParams, hashing.SignRPParams]:
    """The inverse of :func:`from_jax_params`: the pair as numpy arrays
    with the JAX package's dtypes (salts ``uint32``)."""
    return (
        hashing.BitSampleParams(_np(outer.dims), _np(outer.thrs), u32(outer.salts)),
        hashing.SignRPParams(_np(inner.proj), u32(inner.salts)),
    )


def index_to_numpy(ix: pipeline.SLSHIndex) -> pipeline.SLSHIndex:
    """The inverse of :func:`index_from_numpy`: an ``SLSHIndex`` of numpy
    arrays with the JAX package's dtypes (keys and salts ``uint32``, ``n``
    an int32 scalar), for a checkpoint either package restores."""
    hv = ix.heavy
    return pipeline.SLSHIndex(
        *family_to_numpy(ix.outer_params, ix.inner_params),
        tables.TableSet(u32(ix.outer.sorted_keys), _np(ix.outer.sorted_idx)),
        tables.HeavyBuckets(u32(hv.keys), _np(hv.start), _np(hv.size), _np(hv.valid), _np(hv.overflowed)),
        u32(ix.inner_keys),
        _np(ix.inner_idx),
        np.int32(ix.n),
    )


def payload_from_numpy(qdata, meta, device: torch.device | str | None = None) -> payload_mod.Payload:
    """A :class:`~repro_torch.runtime.payload.Payload` from ``qdata`` (n, d)
    float16 or int8 and ``meta`` (n, 2) float32 arrays (for instance the
    JAX package's payload), read through ``np.asarray``, on ``device`` (the
    card unless told otherwise)."""
    device = device_mod.resolve(device)
    q = np.array(qdata)
    if q.dtype not in (np.float16, np.int8):
        raise ValueError(f"payload rows must be float16 or int8, not {q.dtype}")
    m = np.array(meta, dtype=np.float32)
    if m.shape != (q.shape[0], 2):
        raise ValueError(f"meta {m.shape} does not match ({q.shape[0]}, 2)")
    return payload_mod.Payload(torch.as_tensor(q, device=device), torch.as_tensor(m, device=device))


def model_params_from_numpy(cfg, tree: Mapping[str, Any], device: torch.device | str | None = None) -> torch.nn.Module:
    """The serving model for ``cfg`` (a :class:`~repro_torch.models.dense.DenseLM`
    for the dense family, a frozen ``dense.frozen`` tree for the moe, ssm
    and hybrid ones) from the JAX package's parameter tree (nested mappings
    with stacked ``(L, ...)`` layer leaves, hymba's ``segments`` and
    ``meta`` included, for instance
    ``repro.models.api.build_model(cfg).init(key)``), read through
    ``np.asarray`` as float32 and cast to the port's storage dtypes, on
    ``device`` (the card unless told otherwise)."""
    device = device_mod.resolve(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return torch.as_tensor(np.array(node, dtype=np.float32), device=device)

    return model_api.serving_weights(cfg, conv(tree))


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (``ml_dtypes`` bfloat16 included, read by its bits) or
    a tensor as a tensor of its own dtype on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device)
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":  # numpy has no bfloat16: carry its bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, Mapping) else fn(tree)


def train_state_from_numpy(
    cfg, params: Mapping[str, Any], opt_state=None, device: torch.device | str | None = None
) -> tuple[dict, adamw.AdamWState | None]:
    """Training masters and an AdamW state from the JAX package's (for
    instance ``build_model(cfg).init(key)`` and ``adamw.init``, or a
    restored checkpoint), read through ``np.asarray``, on ``device`` (the
    card unless told otherwise), for every model family.

    The masters come back in ``cfg.param_dtype`` with the JAX tree's leaf
    names (hymba's ``segments/seg<i>/...``, moe's ``e_gate``/``e_up``/
    ``e_down`` expert stacks) and require gradients;
    the moments keep their dtypes (float32, or int8 ``q`` of m, uint8 ``q``
    of v and float32 ``s``) and ``step`` is an int32 0-d tensor.
    ``opt_state`` is any object with ``m``, ``v`` and ``step``; None gives
    None."""
    device = device_mod.resolve(device)
    pd = getattr(torch, cfg.param_dtype)
    masters = dense.master_tree(_map(lambda a: _tensor(a, device).to(pd), params))
    if opt_state is None:
        return masters, None
    conv = lambda a: _tensor(a, device)  # noqa: E731
    return masters, adamw.AdamWState(
        _map(conv, opt_state.m), _map(conv, opt_state.v), _tensor(opt_state.step, device).to(torch.int32)
    )


def _host_leaf(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def train_state_to_numpy(params: Mapping[str, Any], opt_state=None) -> tuple[dict, adamw.AdamWState | None]:
    """The inverse of :func:`train_state_from_numpy`: numpy trees with the
    JAX package's dtypes, except that bfloat16 masters widen to float32
    (exactly; numpy has no bfloat16)."""
    host = _map(_host_leaf, params)
    if opt_state is None:
        return host, None
    return host, adamw.AdamWState(_map(_host_leaf, opt_state.m), _map(_host_leaf, opt_state.v),
                                  _host_leaf(opt_state.step))
