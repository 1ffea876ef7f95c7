"""Mesh builders and a one-host launcher (the counterpart of
``repro.launch.mesh``).

The builders are functions: importing this module touches no device and no
process group. Each builds the mesh over the default process group, one
rank per mesh cell, and refuses a world whose size is not the product of
the axes; a one-rank mesh needs no process group at all. Ranks started by
``torchrun`` call them after ``torch.distributed.init_process_group``;
:func:`spawn` starts the ranks of one host itself::

    def rank_main(path):                     # in an importable module
        mesh = make_local_mesh(10, 4)
        index = dslsh.build(0, np.load(path, mmap_mode="r"), cfg, dslsh.mesh(mesh))
        return index.query(queries).knn_idx.cpu().numpy()

    results = spawn(rank_main, 40, store_dir=tmp, args=(path,))

The backend is an explicit argument, and ``"gloo"`` is the one that runs:
any number of ranks on one card (or on the CPU), the Reducer's partials
moving through the host. ``"nccl"`` (one card per rank) is refused until a
machine with more cards has run it (ROADMAP.md, NCCL).
"""
from __future__ import annotations

import datetime
import os
import pickle

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.sharding import ctx


def make_production_mesh(*, multi_pod: bool = False, device=None) -> ctx.Mesh:
    """16 x 16 = 256 ranks over ``("data", "model")``; with ``multi_pod``,
    2 x 16 x 16 = 512 with a leading ``"pod"`` axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ctx.make_mesh(axes, shape, device)


def make_local_mesh(data: int = 1, model: int = 1, *, device=None) -> ctx.Mesh:
    """A ``(data, model)`` mesh: the paper's nodes and cores per node.
    ``device`` is this rank's device (the card unless told otherwise)."""
    return ctx.make_mesh(("data", "model"), (data, model), device)


def make_replicated_mesh(rep: int = 1, data: int = 1, model: int = 1, *, device=None) -> ctx.Mesh:
    """A mesh with a leading replica axis: each ``(data, model)`` cell
    exists ``rep`` times, and ``distributed.mesh_query`` row-shards a query
    batch over ``rep`` (DESIGN.md §10)."""
    return ctx.make_mesh(("rep", "data", "model"), (rep, data, model), device)


def _rank_main(rank, fn, args, world, store_dir, backend, timeout_s):
    """One spawned rank: join the process group, run ``fn(*args)``, write
    its return value for :func:`spawn` to collect."""
    torch.set_num_threads(1)
    # the ranks of one host talk over loopback, whatever the host name
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        out = fn(*args)
        tmp = os.path.join(store_dir, f"rank{rank}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, os.path.join(store_dir, f"rank{rank}.pkl"))
    finally:
        dist.destroy_process_group()


def spawn(
    fn, world: int, *, store_dir: str, backend: str = "gloo",
    timeout_s: float = 300.0, args: tuple = (),
) -> list:
    """Run ``fn(*args)`` on ``world`` ranks of this host -> their return
    values, in rank order.

    Each rank is a process forked from a fresh fork server that has
    imported ``fn``'s module (``forkserver``: no rank inherits this
    process's state, and none imports torch anew), so ``fn`` must be
    importable by name and its return value picklable. The ranks rendezvous through a
    ``FileStore`` in ``store_dir`` (an empty directory the caller owns; no
    port is opened for it), run ``torch.set_num_threads(1)``, and
    give up on a collective after ``timeout_s``, so a dead rank fails the
    run instead of hanging it. If any rank fails, the others are stopped
    and the error is raised here.
    """
    ctx.check_backend(backend)
    os.makedirs(store_dir, exist_ok=True)
    mp.get_context("forkserver").set_forkserver_preload([__name__, fn.__module__])
    mp.start_processes(
        _rank_main,
        args=(fn, tuple(args), world, store_dir, backend, float(timeout_s)),
        nprocs=world, join=True, start_method="forkserver",
    )
    out = []
    for r in range(world):
        with open(os.path.join(store_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
