"""One DSLSH mesh deployment run on every rank: build, query, save, load.

What :func:`repro_torch.launch.mesh.spawn` runs for a mesh deployment on
one host::

    job = MeshJob(mesh=(10, 4), data="points.npy", queries="queries.npy",
                  cfg=dict(m_out=32, L_out=16, ...),
                  steps=(("query", {}), ("query", {"reducer": "tree"})))
    reports = spawn(run, 40, store_dir=tmp, args=(job,))

Each rank builds its mesh (``make_local_mesh``, or ``make_replicated_mesh``
for a three-axis shape), its cell through ``dslsh.build`` over the
memory-mapped dataset (it reads only its node's rows), then runs the
job's steps through the handle: ``("query", {reducer, drop_mask,
max_cells})``, ``("save", path)`` and ``("load", path)``. Every step
starts on a barrier and is timed to its end on the device. The report of
each rank gives its coordinates, a digest of its root hash family, the
build and each step (seconds, kernel launches, the Reducer's seconds and
bytes, and the answer: whole on rank 0, a digest elsewhere, since every
rank must hold the same one) and its peak device memory.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import distributed as D
from repro_torch.kernels import _build
from repro_torch.launch import mesh as mesh_mod
from repro_torch.sharding import ctx


@dataclasses.dataclass(frozen=True)
class MeshJob:
    """What every rank of a mesh run does (see the module docstring)."""

    mesh: tuple[int, ...]  # (data, model) or (rep, data, model)
    data: str  # path of the (n, d) float32 dataset (.npy)
    queries: str  # path of the (Q, d) query batch (.npy)
    cfg: dict  # SLSHConfig.compose keywords
    seed: int = 0  # the root family's seed (unused with ``params``)
    # an .npz of the root family (outer_dims, outer_thrs, outer_salts,
    # inner_proj, inner_salts), for instance the JAX package's
    params: str | None = None
    routed: bool = False
    steps: tuple = ()
    device: str | None = None  # the rank's device (the card unless told otherwise)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _answer(res: D.DistributedQueryResult) -> dict:
    return {
        f: getattr(res, f).cpu().numpy()
        for f in ("knn_dist", "knn_idx", "comparisons", "compaction_overflow", "routed")
    }


def _timed(mesh: ctx.Mesh, fn):
    """``fn()`` started on a barrier -> (its value, its seconds to the end
    on the device, its kernel launches, the Reducer's counters)."""
    ctx.barrier(mesh)
    _sync(mesh.device)
    _build.reset_launches()
    D.reset_reducer()
    t0 = time.perf_counter()
    out = fn()
    _sync(mesh.device)
    return out, time.perf_counter() - t0, dict(_build.LAUNCHES), dict(D.REDUCER)


def run(job: MeshJob) -> dict:
    """Run ``job`` on this rank (every rank of the process group calls it)
    -> this rank's report."""
    make = mesh_mod.make_replicated_mesh if len(job.mesh) == 3 else mesh_mod.make_local_mesh
    mesh = make(*job.mesh, device=job.device)
    cfg = api.make_config(**job.cfg)
    params = None
    if job.params is not None:
        with np.load(job.params) as f:
            params = (
                {k: f[f"outer_{k}"] for k in ("dims", "thrs", "salts")},
                {k: f[f"inner_{k}"] for k in ("proj", "salts")},
            )
    data = np.load(job.data, mmap_mode="r")
    queries = torch.as_tensor(np.load(job.queries), device=mesh.device)
    deploy = api.mesh(mesh, routed=job.routed)
    index, build_s, build_launches, _ = _timed(mesh, lambda: api.build(job.seed, data, cfg, deploy, params=params))
    cell = index.pipeline_index
    report = {
        "rank": mesh.rank,
        "coords": mesh.coords,
        "family_digest": _digest([*D.mesh_family(mesh, cell), *cell.inner_params]),
        "build_s": build_s,
        "build_launches": build_launches,
        "steps": [],
        "cpu_count": os.cpu_count(),
    }
    for op, arg in job.steps:
        entry = {"op": op}
        if op == "query":
            kw = dict(arg)
            h = index
            if "reducer" in kw:
                h = copy.copy(index)
                h.deploy = dataclasses.replace(index.deploy, reducer=kw.pop("reducer"))
            if kw.get("drop_mask") is not None:
                kw["drop_mask"] = np.asarray(kw["drop_mask"], bool)
            res, entry["seconds"], entry["launches"], entry["reducer"] = _timed(mesh, lambda: h.query(queries, **kw))
            answer = _answer(res)
            entry["digest"] = _digest([torch.from_numpy(a) for a in answer.values()])
            if mesh.rank == 0:
                entry["answer"] = answer
        elif op == "save":
            _, entry["seconds"], _, _ = _timed(mesh, lambda: index.save(arg))
        elif op == "load":
            index, entry["seconds"], _, _ = _timed(mesh, lambda: api.load(arg, device_mesh=mesh))
        else:
            raise ValueError(f"unknown mesh job step {op!r}")
        report["steps"].append(entry)
    if mesh.device.type == "cuda":
        report["peak_mem_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    return report
