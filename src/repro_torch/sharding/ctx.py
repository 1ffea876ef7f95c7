"""A device mesh over ``torch.distributed`` and the collectives the DSLSH
mesh needs (the counterpart of ``repro.sharding.ctx``).

JAX runs one program over a mesh of devices with ``shard_map``. The port
runs one process per mesh cell instead (SPMD): every rank runs the body
that ``shard_map`` would trace, and holds one :class:`Mesh` naming the
axes, the mesh's shape, this rank's coordinates and its device, with one
process group per axis line the rank sits on. ``lax.axis_index``,
``lax.all_gather`` and ``lax.ppermute`` become :func:`axis_index`,
:func:`all_gather` and :func:`ppermute`; JAX's ``axis_size`` and
``mesh_axis_size`` read ``Mesh.shape``; a ``PartitionSpec`` becomes a
tuple of axis names per leading dim (:class:`NamedSharding`).

Transport. The backend is the caller's explicit choice
(``launch.mesh``), and gloo is the only one taken: :func:`make_mesh`
refuses any other (NCCL, one card per rank, waits for a machine with more
cards; ROADMAP.md). Gloo moves host tensors only, so a collective copies a
device tensor to the host and its result back, on purpose; :data:`TRAFFIC`
counts those copies (``host_copy_bytes``) and the bytes this rank hands to
the transport (``sent_bytes``).

A mesh of one rank needs no process group: every collective is then the
identity (``all_gather`` stacks the one tensor), so a single process runs
``make_local_mesh(1, 1)`` as JAX runs it on one device.

``ShardingRules``, ``logical_to_spec`` and ``constrain`` (LM training
under a mesh) are not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as device_mod

TRAFFIC = {"host_copy_bytes": 0, "sent_bytes": 0}


def check_backend(backend: str) -> None:
    """Refuse a mesh backend other than gloo, the one that has run."""
    if backend != "gloo":
        raise NotImplementedError(
            f"mesh backend {backend!r}: only 'gloo' runs the mesh (its collectives"
            " move host tensors); NCCL with one card per rank is not ported yet"
            " (ROADMAP.md, Queue 1, NCCL)"
        )


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a device mesh: axis names and sizes, its own
    coordinates and device, the backend (None for a one-rank mesh) and one
    process group per axis of size > 1 (the line through this rank)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    coords: tuple[int, ...]
    device: torch.device
    backend: str | None = None
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Ranks in the mesh."""
        return math.prod(self.axis_sizes)

    @property
    def rank(self) -> int:
        """This rank's global rank (its coordinates, row-major)."""
        return self.rank_of(self.coords)

    def rank_of(self, coords) -> int:
        """The global rank at ``coords`` (row-major over the axes)."""
        return int(np.ravel_multi_index(tuple(coords), self.axis_sizes))

    def line(self, axis: str) -> list[int]:
        """Global ranks along ``axis`` through this rank, in axis order."""
        i = self.axis_names.index(axis)
        return [
            self.rank_of(self.coords[:i] + (j,) + self.coords[i + 1 :])
            for j in range(self.axis_sizes[i])
        ]


def make_mesh(
    axis_names: tuple[str, ...], shape: tuple[int, ...],
    device: str | torch.device | None = None,
) -> Mesh:
    """The mesh ``shape`` over ``axis_names`` on the default process group.

    Every rank must call this, in the same order as the others: it makes
    one process group per axis line, collectively. With no process group
    initialized only a one-rank mesh is possible. ``device`` is this rank's
    device (the card unless told otherwise).
    """
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    dev = device_mod.resolve(device)
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"a {'x'.join(map(str, shape))} mesh over {axis_names} needs"
                f" {size} ranks, but no process group is initialized: start the"
                " ranks with repro_torch.launch.mesh.spawn (or torchrun and"
                " torch.distributed.init_process_group) first"
            )
        return Mesh(tuple(axis_names), shape, (0,) * len(shape), dev)
    world = dist.get_world_size()
    if world != size:
        raise ValueError(
            f"the process group has {world} ranks, but a"
            f" {'x'.join(map(str, shape))} mesh over {axis_names} needs {size}"
            " (one rank per mesh cell)"
        )
    check_backend(dist.get_backend())
    coords = tuple(int(c) for c in np.unravel_index(dist.get_rank(), shape))
    mesh = Mesh(tuple(axis_names), shape, coords, dev, "gloo")
    rank = mesh.rank
    for i, name in enumerate(axis_names):
        if shape[i] == 1:
            continue
        others = [range(s) for j, s in enumerate(shape) if j != i]
        for rest in np.ndindex(*[len(r) for r in others]):
            ranks = [
                mesh.rank_of(rest[:i] + (j,) + rest[i:]) for j in range(shape[i])
            ]
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[name] = group
    return mesh


def axis_index(mesh: Mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    return mesh.coords[mesh.axis_names.index(axis)]


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as gloo takes it: contiguous, bool as uint8, on the host (the
    copy counted)."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.device.type != "cpu":
        TRAFFIC["host_copy_bytes"] += t.nbytes
        t = t.cpu()
    return t


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received tensor back on ``like``'s device and dtype."""
    if t.device != like.device:
        TRAFFIC["host_copy_bytes"] += t.nbytes
        t = t.to(like.device)
    return t.to(torch.bool) if like.dtype == torch.bool else t


def all_gather(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` from every rank on this rank's ``axis`` line, stacked in axis
    order along a new leading dim (``lax.all_gather``)."""
    group = mesh.groups.get(axis)
    if group is None:  # an axis of size 1
        return t[None]
    src = _wire(t)
    out = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, src, group=group)
    TRAFFIC["sent_bytes"] += src.nbytes
    return _unwire(torch.stack(out), t)


def ppermute(mesh: Mesh, axis: str, t: torch.Tensor, perm) -> torch.Tensor:
    """Send ``t`` along ``axis`` by ``perm``, a list of ``(src, dst)`` axis
    indices (``lax.ppermute``): each rank gets the tensor its source sent,
    and a rank that receives nothing gets zeros."""
    me = axis_index(mesh, axis)
    line = mesh.line(axis)
    if len({s for s, _ in perm}) != len(perm) or len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute needs unique sources and destinations: {perm}")
    sources = [s for s, d in perm if d == me]
    src = _wire(t)
    out = None
    reqs = []
    for s, d in perm:
        if s != me:
            continue
        if d == me:
            out = src.clone()
        else:
            reqs.append(dist.isend(src, line[d]))
            TRAFFIC["sent_bytes"] += src.nbytes
    if sources and sources[0] != me:
        out = torch.empty_like(src)
        reqs.append(dist.irecv(out, line[sources[0]]))
    for r in reqs:
        r.wait()
    if out is None:
        return torch.zeros_like(t)
    return _unwire(out, t)


def gather_to(mesh: Mesh, t: torch.Tensor, sources: list[int], dst: int = 0) -> list | None:
    """``t`` from each global rank in ``sources`` (all of one shape and
    dtype) -> the list of them on rank ``dst``, in ``sources`` order, as
    host tensors; None on every other rank."""
    me = mesh.rank
    if me != dst:
        if me in sources:
            src = _wire(t)
            dist.send(src, dst)
            TRAFFIC["sent_bytes"] += src.nbytes
        return None
    own = _wire(t)
    out, reqs = [], []
    for s in sources:
        if s == me:
            out.append(own.cpu())
            continue
        buf = torch.empty(own.shape, dtype=own.dtype)
        reqs.append(dist.irecv(buf, s))
        out.append(buf)
    for r in reqs:
        r.wait()
    return [o.to(torch.bool) if t.dtype == torch.bool else o for o in out]


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (nothing for a one-rank mesh)."""
    if mesh.backend is not None:
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Which leading dims of an array are split over which mesh axes: the
    counterpart of ``NamedSharding(mesh, PartitionSpec(...))``. ``spec``
    holds, per leading dim, an axis name, a tuple of names (split over
    their product, row-major) or None (whole); dims past it are whole."""

    mesh: Mesh
    spec: tuple = ()

    def block(self, arr):
        """This rank's block of ``arr`` (numpy or torch, sliced lazily)."""
        index = []
        shape = self.mesh.shape
        for dim, axes in enumerate(self.spec):
            if axes is None:
                index.append(slice(None))
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            n = math.prod(shape[a] for a in axes)
            i = int(np.ravel_multi_index(
                tuple(axis_index(self.mesh, a) for a in axes), tuple(shape[a] for a in axes)
            ))
            if arr.shape[dim] % n:
                raise ValueError(
                    f"dim {dim} of size {arr.shape[dim]} does not split over"
                    f" {axes} ({n} blocks)"
                )
            b = arr.shape[dim] // n
            index.append(slice(i * b, (i + 1) * b))
        return arr[tuple(index)]
