"""Fault-tolerant checkpointing: per-leaf .npy + manifest, atomic renames,
optional async writes (the counterpart of ``repro.checkpoint.store``).

Layout:  <dir>/step_<k>/manifest.json + <dir>/step_<k>/<leaf>.npy
A checkpoint directory becomes visible only via ``os.replace`` (atomic), so
a crash mid-write never yields a readable-but-corrupt checkpoint.

The format is the JAX package's, so either package reads what the other
wrote. A tree is nested dicts, lists and NamedTuples over leaves (torch
tensors, numpy arrays, Python scalars); a leaf's file name joins its path
as ``jax.tree_util`` spells one: a dict key as itself (keys visited in
sorted order), a list index as its number, a NamedTuple field as
``.<field>``, all joined with ``_`` (``state_index_.outer_params_.dims``).
bfloat16 leaves are stored as a ``uint16`` view with ``"bfloat16"`` in the
manifest and read back through torch's ``view(torch.bfloat16)``, so no
``ml_dtypes`` is needed.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: tuple = ()) -> list[tuple[tuple, object]]:
    """``(path, leaf)`` pairs in the JAX package's flattening order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in _flatten(getattr(tree, f), path + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, path + (str(i),))]
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def leaf_names(tree) -> list[str]:
    """The file name of every leaf of ``tree``, in flattening order."""
    return ["_".join(_SAFE.sub("-", p) for p in path) or "root" for path, _ in _flatten(tree)]


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array to write and the manifest's dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: store its bits
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(tree, step: int, ckpt_dir: str, *, blocking: bool = True):
    """Save a tree checkpoint. Returns the final directory path, or
    ``(path, thread)`` with ``blocking=False`` (the write runs on the
    thread; the tensors are copied to the host before it starts)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    host = [(name, *_host(leaf)) for name, (_, leaf) in zip(leaf_names(tree), _flatten(tree))]

    def _write():
        os.makedirs(tmp, exist_ok=True)
        names, dtypes = [], {}
        for name, arr, dtype in host:
            dtypes[name] = dtype
            np.save(os.path.join(tmp, f"{name}.npy"), arr)
            names.append(name)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": names, "dtypes": dtypes}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    if blocking:
        _write()
        return final
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return final, t


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete step in ``ckpt_dir`` (None when there is none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, dtype: str | None, device):
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return t if device is None else t.to(device)
    if device is None:
        return arr
    if arr.dtype == np.uint32:  # torch's uint32 is barely supported: widen
        arr = arr.astype(np.int64)
    return torch.as_tensor(arr, device=device)


def _sharded_leaf(file: str, dtype: str | None, sharding):
    """This rank's block of a saved leaf, on its mesh's device; a split
    leaf is read memory-mapped, so only the block leaves the disk."""
    arr = np.load(file, mmap_mode="r" if sharding.spec else None)
    return _leaf(np.array(sharding.block(arr)), dtype, sharding.mesh.device)


def restore(tree_like, step: int, ckpt_dir: str, device=None, shardings=None):
    """Restore into the structure of ``tree_like`` (its leaves are only
    placeholders). With ``device=None`` leaves come back as numpy arrays
    (bfloat16 ones as CPU torch tensors, numpy having no such type); with a
    ``device`` every leaf is a torch tensor there, ``uint32`` widened to
    ``int64`` as the port carries 32-bit keys.

    ``shardings``, a tree matching ``tree_like`` of
    :class:`repro_torch.sharding.ctx.NamedSharding`, places each leaf on a
    mesh instead: this rank keeps only its block (the leading dims its
    spec splits over the mesh axes, indexed by its coordinates; a spec of
    ``()`` keeps the whole leaf), as a tensor on the mesh's device. This
    is how a restart onto another mesh re-shards the state."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["step"] != step:
        raise ValueError(f"{path} holds step {manifest['step']}, not {step}")
    dtypes = manifest.get("dtypes", {})
    names = leaf_names(tree_like)
    files = [os.path.join(path, f"{n}.npy") for n in names]
    if shardings is not None:
        specs = [s for _, s in _flatten(shardings)]
        if len(specs) != len(names):
            raise ValueError(f"shardings has {len(specs)} leaves, the tree {len(names)}")
        leaves = [_sharded_leaf(f, dtypes.get(n), s) for f, n, s in zip(files, names, specs)]
        return _unflatten(tree_like, iter(leaves))
    dev = None if device is None else torch.device(device)
    leaves = [_leaf(np.load(f), dtypes.get(n), dev) for f, n in zip(files, names)]
    return _unflatten(tree_like, iter(leaves))


def restore_latest(tree_like, ckpt_dir: str, device=None):
    """``(tree, step)`` of the newest checkpoint, or ``(None, None)``."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return restore(tree_like, step, ckpt_dir, device), step
