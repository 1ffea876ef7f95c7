"""A device mesh over ``torch.distributed``, the sharding rules, and the
collectives of the DSLSH mesh and of the LM families under a mesh (the
counterpart of ``repro.sharding.ctx``).

Execution model. JAX runs one program over a mesh of devices and places
each tensor by GSPMD (``with_sharding_constraint``, ``shard_map``). The
port runs one process per mesh cell instead (SPMD): every rank runs the
program on its own block of each tensor and holds one :class:`Mesh`
naming the axes, the mesh's shape, this rank's coordinates and its
device, with one process group per axis line the rank sits on.
``lax.axis_index``, ``lax.all_gather`` and ``lax.ppermute`` become
:func:`axis_index`, :func:`all_gather` and :func:`ppermute`; JAX's
``axis_size`` and ``mesh_axis_size`` read ``Mesh.shape``; a
``PartitionSpec`` becomes a tuple of axis names per leading dim
(:class:`NamedSharding`).

The holding rule of the LM families. :class:`ShardingRules` maps the
logical axis names of every parameter, input and cache leaf to mesh axes
exactly as the JAX package does (:func:`logical_to_spec`, the same
defaults and the same dropping of non-dividing axes), and a rank of the
port holds its block (:meth:`NamedSharding.block`) of every leaf under
that spec, along every axis: ``batch`` (inputs and caches: the rank's
rows), ``expert`` (the rank's experts), ``seq`` (attention caches, read by
context-parallel decode attention), ``fsdp`` (parameters and optimizer
state, ZeRO) and ``tensor`` (heads, FFN columns, the vocabulary, SSM heads
and channels). A leaf is whole along an axis only where
:func:`logical_to_spec` drops it. The model code puts a leaf back
together where it needs more than its block: :func:`gather_dims`
all-gathers the ``fsdp`` and ``tensor`` dims of a weight just before use
(ZeRO; its backward reduce-scatters the gradient in float32), except
where a tensor-parallel matmul consumes the rank's block of heads, FFN
columns or vocabulary as it is (``models.dense``, ``models.common``), and
:func:`keep_dims` cuts a result computed whole back to the rank's block
(SSM caches).

The activation layout. Between blocks a rank holds its rows (``batch``)
and its block of positions (``seq``, JAX's sequence-parallel layout) of
the residual stream, wherever the ``seq`` axes divide the sequence
(:func:`seq_split`; decode's one token stays whole). :func:`constrain`
puts a tensor the ranks computed alike and whole along its ``seq`` dims
into that layout (:func:`keep_block`), as the JAX function constrains
GSPMD; the model code gathers the positions where an operation needs them
all (attention, the SSM scan, a tensor-parallel matmul, the
vocabulary-parallel loss) and returns to the layout by a reduce-scatter
(:func:`psum_scatter`) or :func:`keep_block`.

Gradients. The collectives of the LM path (:func:`psum`, :func:`pmean`,
:func:`psum_scatter`, :func:`all_gather_tiled`, :func:`all_to_all`) are
``torch.autograd.Function``s whose backward is the transpose of the
forward, as JAX differentiates ``shard_map``: a psum's is a psum, a tiled
all-gather's a psum-scatter and back, an all-to-all's the reverse
all-to-all. With every rank computing the global loss, the gradient of
``loss / mesh.size`` on each rank, summed over the mesh axes a leaf is
replicated on, is the gradient of the one-process loss
(``train.loop``). :func:`pmax` passes no gradient: decode attention uses
it as a shift that cancels.

Transport. The backend is the caller's explicit choice
(``launch.mesh``), and gloo is the only one taken: :func:`make_mesh`
refuses any other (NCCL, one card per rank, waits for a machine with more
cards; ROADMAP.md). Gloo moves host tensors only, so a collective copies a
device tensor to the host and its result back, on purpose; :data:`TRAFFIC`
counts those copies (``host_copy_bytes``) and the bytes this rank hands to
the transport (``sent_bytes``). A sum over ranks is an all-gather and a
sum in rank order, so every rank gets the same bits whatever the dtype
(gloo may lack a bf16 reduction).

A mesh of one rank needs no process group: every collective is then the
identity (``all_gather`` stacks the one tensor), so a single process runs
``make_local_mesh(1, 1)`` as JAX runs it on one device. A *dry* mesh
(:func:`dry_mesh`) has the production mesh's shape, this rank's
coordinates, no process group and the ``meta`` device: its collectives
return outputs of the right shape and add their output bytes to
:data:`DRY_BYTES` under the HLO names, which is how ``launch.dryrun``
traces one rank's program.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as device_mod

TRAFFIC = {"host_copy_bytes": 0, "sent_bytes": 0}
# a dry mesh's collectives: output bytes by HLO collective name
DRY_BYTES: dict[str, float] = {}


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
    backend: str | None = None  # "gloo", None (one rank) or "dry"
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def dry(self) -> bool:
        """A dry mesh: shapes and byte tallies, no transport."""
        return self.backend == "dry"

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
    copy counted; a card's tensor lands in pinned memory, which the card
    copies to and from faster)."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.device.type != "cpu":
        TRAFFIC["host_copy_bytes"] += t.nbytes
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    return t


def _host_like(t: torch.Tensor, shape=None) -> torch.Tensor:
    """An empty host tensor of ``t``'s dtype (and shape), pinned where
    ``t`` is: a buffer that gloo fills and the card then reads."""
    return torch.empty(t.shape if shape is None else shape, dtype=t.dtype, pin_memory=t.is_pinned())


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
    """Wait for every rank of the mesh (nothing for a one-rank or a dry
    mesh)."""
    if mesh.backend == "gloo":
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Which leading dims of an array are split over which mesh axes: the
    counterpart of ``NamedSharding(mesh, PartitionSpec(...))``. ``spec``
    holds, per leading dim, an axis name, a tuple of names (split over
    their product, row-major) or None (whole); dims past it are whole.
    A rank holds its :meth:`block` under ``spec``."""

    mesh: Mesh
    spec: tuple = ()

    def _cuts(self, shape, spec):
        """Per dim of ``shape``: (number of blocks, this rank's block)."""
        out = []
        for dim, axes in enumerate(spec):
            if axes is None:
                out.append((1, 0))
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            sizes = tuple(self.mesh.shape[a] for a in axes)
            i = int(np.ravel_multi_index(tuple(axis_index(self.mesh, a) for a in axes), sizes))
            n = math.prod(sizes)
            if shape[dim] % n:
                raise ValueError(
                    f"dim {dim} of size {shape[dim]} does not split over"
                    f" {axes} ({n} blocks)"
                )
            out.append((n, i))
        return out

    def axes(self) -> tuple:
        """The mesh axes that cut this rank's block, in spec order."""
        return tuple(a for ax in self.spec if ax is not None for a in ((ax,) if isinstance(ax, str) else ax))

    def block(self, arr):
        """This rank's block of ``arr`` (numpy or torch, sliced lazily)."""
        index = []
        for dim, (n, i) in enumerate(self._cuts(arr.shape, self.spec)):
            b = arr.shape[dim] // n
            index.append(slice(i * b, (i + 1) * b))
        return arr[tuple(index)]

    def block_shape(self, shape) -> tuple:
        """The shape of this rank's block of a ``shape`` array."""
        cuts = self._cuts(shape, self.spec)
        return tuple(s // cuts[d][0] if d < len(cuts) else s for d, s in enumerate(shape))


def dry_mesh(axis_names: tuple[str, ...], shape: tuple[int, ...], coords: tuple[int, ...] | None = None) -> Mesh:
    """A mesh of ``shape`` seen from the rank at ``coords`` (the first by
    default) with no process group, on the ``meta`` device: its
    collectives tally bytes in :data:`DRY_BYTES` and move nothing."""
    shape = tuple(int(s) for s in shape)
    return Mesh(tuple(axis_names), shape, tuple(coords or (0,) * len(shape)), torch.device("meta"), "dry")


# ------------------------------------------------------------ sharding rules
@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-axis -> mesh-axis mapping for the (pod, [rep,] data, model)
    mesh. ``rep`` (replicated DSLSH cells, DESIGN.md §10) joins the batch
    axes — replicas split query/batch rows — but never the parameter axes:
    replicas hold identical state by construction."""

    batch: tuple = ("pod", "rep", "data")  # data parallel (+ replica split)
    fsdp: tuple = ("pod", "data")  # parameter/optimizer sharding (ZeRO)
    tensor: tuple = ("model",)  # tensor parallel (heads / ffn / vocab / experts)
    seq: tuple = ("model",)  # sequence parallel (activations between blocks)
    expert: tuple = ("model",)  # expert parallel

    def axes(self, logical: str | None) -> tuple:
        if logical is None:
            return (None,)
        return getattr(self, logical)


_STATE: dict[str, Any] = {"mesh": None, "rules": ShardingRules()}


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None, rules: ShardingRules | None = None):
    """Make ``mesh`` (and ``rules``) ambient for the model code run inside."""
    old = dict(_STATE)
    _STATE["mesh"] = mesh
    if rules is not None:
        _STATE["rules"] = rules
    try:
        yield
    finally:
        _STATE.update(old)


def get_mesh() -> Mesh | None:
    return _STATE["mesh"]


def get_rules() -> ShardingRules:
    return _STATE["rules"]


def axis_size(mesh: Mesh, axes: tuple) -> int:
    return math.prod(mesh.shape[a] for a in axes if a is not None and a in mesh.shape)


def logical_to_spec(mesh, rules: ShardingRules, logical: tuple, shape: tuple) -> tuple:
    """Resolve logical axes to a spec (a PartitionSpec's entries),
    dropping non-divisible dims: an axis already used by an earlier dim is
    skipped, and an axis tuple that does not divide the dim is cut to its
    longest prefix that does. ``mesh`` needs only ``.shape``."""
    spec = []
    used: set = set()
    for dim, name in enumerate(logical):
        axes = tuple(
            a
            for a in rules.axes(name)
            if a is not None and a in mesh.shape and a not in used
        )
        if not axes:
            spec.append(None)
            continue
        size = math.prod(mesh.shape[a] for a in axes)
        if shape[dim] % size != 0:
            # try progressively shorter prefixes of the axis tuple
            while axes and shape[dim] % math.prod(mesh.shape[a] for a in axes) != 0:
                axes = axes[:-1]
        if axes:
            used.update(axes)
            spec.append(axes if len(axes) > 1 else axes[0])
        else:
            spec.append(None)
    return tuple(spec)


def sharding_for(mesh: Mesh, logical: tuple, shape: tuple) -> NamedSharding:
    """The leaf's :class:`NamedSharding` on ``mesh``: the JAX package's
    spec, of which a rank holds its block."""
    return NamedSharding(mesh, logical_to_spec(mesh, get_rules(), tuple(logical), tuple(shape)))


def _named_cuts(mesh: Mesh, logical: tuple, shape: tuple, names: tuple) -> tuple:
    """``((live mesh axes, dim), ...)`` of the dims whose logical axis is in
    ``names``, as the spec of a ``shape`` leaf splits them. The other dims
    are resolved as whole, so their sizes in ``shape`` are not read; the
    rules' ``batch`` axes, the only ones a named dim could share, never
    meet ``fsdp`` in one leaf."""
    masked = tuple(n if n in names else None for n in logical)
    spec = logical_to_spec(mesh, get_rules(), masked, tuple(shape))
    return tuple((_live(mesh, axes), dim) for dim, axes in enumerate(spec) if axes is not None and _live(mesh, axes))


def gather_dims(x: torch.Tensor, logical: tuple, shape: tuple, names: tuple = ("fsdp", "tensor"),
                dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x``, this rank's block of a leaf of global ``shape`` with
    ``logical`` axes, cast to ``dtype`` (where given) and all-gathered whole
    along every dim whose logical axis is in ``names`` (ZeRO's gather of a
    weight before use). Its backward reduce-scatters the gradient in
    float32 and returns it in ``x``'s dtype. Without a mesh, ``x`` cast."""
    mesh = get_mesh()
    cuts = () if mesh is None else _named_cuts(mesh, logical, shape, names)
    if not cuts:
        return x if dtype is None else x.to(dtype)
    return _AllGatherTiled.apply(mesh, cuts, x, dtype)


def keep_dims(x: torch.Tensor, logical: tuple, names: tuple = ("tensor",)) -> torch.Tensor:
    """This rank's block of ``x`` (a whole leaf, at its global shape, which
    the ranks compute alike) along every dim whose logical axis is in
    ``names``: the inverse of :func:`gather_dims` for results computed
    whole (:func:`keep_block`)."""
    mesh = get_mesh()
    if mesh is None:
        return x
    for axes, dim in _named_cuts(mesh, logical, tuple(x.shape), names):
        x = keep_block(mesh, axes, x, dim)
    return x


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """The JAX package's sharding constraint by logical axis names, on a
    rank's tensor whole along its ``seq`` dims (its ``batch`` dims are its
    rows already): this rank's block along every ``seq`` dim the spec
    splits (:func:`keep_dims`; a dim that does not divide stays whole, as
    in JAX). Other names are checked against ``x.ndim`` and move nothing:
    a ``tensor`` dim is whole or already the rank's block of columns, as
    the weights it came from were gathered or not."""
    if get_mesh() is None:
        return x
    assert len(logical) == x.ndim, (logical, tuple(x.shape))
    return keep_dims(x, logical, ("seq",))


def seq_split(length: int) -> tuple:
    """The live mesh axes that split a sequence of ``length`` positions
    between blocks (the ``seq`` entry of the spec of ``("batch", "seq",
    None)``; the rules' ``batch`` and ``seq`` axes are disjoint); () without
    a mesh or where they do not divide ``length``."""
    mesh = get_mesh()
    if mesh is None:
        return ()
    cuts = _named_cuts(mesh, (None, "seq"), (1, length), ("seq",))
    return cuts[0][0] if cuts else ()


def spec_for(shape: tuple, *logical: str | None) -> tuple:
    """The JAX package's spec of a ``shape`` leaf on the ambient mesh (the
    dry-run uses this); ``()`` without one."""
    mesh = get_mesh()
    if mesh is None:
        return ()
    return logical_to_spec(mesh, get_rules(), tuple(logical), shape)


def mesh_axis_size(*axes_names: str) -> int:
    mesh = get_mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape.get(a, 1) for a in axes_names)


def batch_axes(mesh: Mesh | None = None) -> tuple:
    """The mesh axes the batch is split over (the rules' ``batch`` axes the
    mesh has, of size > 1)."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in get_rules().batch if a in mesh.shape and mesh.shape[a] > 1)


# ------------------------------------------------------------ LM collectives
def _live(mesh: Mesh, axes) -> tuple:
    """The axes of ``axes`` (a name or a tuple) that the mesh has with size > 1."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if a in mesh.shape and mesh.shape[a] > 1)


def _tally(kind: str, t: torch.Tensor) -> None:
    DRY_BYTES[kind] = DRY_BYTES.get(kind, 0.0) + float(t.numel() * t.element_size())


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A host tensor as gloo moves it: bf16 and f16 as their bytes (gloo
    may lack both types)."""
    return t.reshape(-1).view(torch.uint8) if t.dtype in (torch.bfloat16, torch.float16) else t


def _cooked(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return r.view(like.dtype).reshape(like.shape) if r.dtype != like.dtype and like.dtype != torch.bool else r


def _all_gather_flat(out: torch.Tensor, src: torch.Tensor, group) -> None:
    """The flat host tensors of an axis line's ranks into ``out`` (their
    concatenation in rank order): one buffer, no list of parts to join."""
    with warnings.catch_warnings():  # renamed in later torch releases; the same collective
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group)


def _gather_stack(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` from every rank on this rank's ``axis`` line, stacked in axis
    order along a new leading dim, on ``t``'s device."""
    host = _wire(t)
    src = _raw(host).reshape(-1)
    out = _host_like(src, (mesh.shape[axis] * src.numel(),))
    _all_gather_flat(out, src, mesh.groups[axis])
    TRAFFIC["sent_bytes"] += src.nbytes
    return _unwire(out.view(host.dtype).reshape((mesh.shape[axis],) + tuple(host.shape)), t)


# a sum over an axis of at least this many bytes goes as a reduce-scatter
# and an all-gather of the summed blocks (each rank moves the tensor about
# once, not n - 1 times); a smaller one as one all-gather of the whole
SCATTER_SUM_BYTES = 1 << 20


def _sum_over(mesh: Mesh, axes: tuple, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over ``axes``, each summed in rank order, in ``t``'s
    dtype, the same bits on every rank whichever form moves it."""
    for a in axes:
        n = mesh.shape[a]
        if t.numel() % n == 0 and t.numel() * t.element_size() >= SCATTER_SUM_BYTES:
            block = _scatter_sum(mesh, (a,), t.reshape(-1), 0)
            t = _gather_stack(mesh, a, block).reshape(t.shape)
            continue
        parts = _gather_stack(mesh, a, t)
        acc = parts[0]
        for p in parts[1:]:  # rank order, in t's dtype
            acc = acc + p
        t = acc
    return t


def _gather_tiled(mesh: Mesh, axes: tuple, t: torch.Tensor, dim: int) -> torch.Tensor:
    for a in reversed(axes):  # the last axis varies fastest in the block index
        parts = _gather_stack(mesh, a, t)
        t = parts.reshape((-1,) + tuple(t.shape[1:])) if dim == 0 else torch.cat(parts.unbind(0), dim=dim)
    return t


def _my_block(mesh: Mesh, axes: tuple, t: torch.Tensor, dim: int) -> torch.Tensor:
    for a in axes:  # the first axis varies slowest
        n = mesh.shape[a]
        b = t.shape[dim] // n
        t = t.narrow(dim, axis_index(mesh, a) * b, b)
    return t


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, mesh, axes, x):
        ctx_.mesh, ctx_.axes = mesh, axes
        if mesh.dry:
            _tally("all-reduce", x)
            return x.clone()
        return _sum_over(mesh, axes, x)

    @staticmethod
    def backward(ctx_, g):
        return None, None, _Psum.apply(ctx_.mesh, ctx_.axes, g)


class _AllGatherTiled(torch.autograd.Function):
    """Tiled all-gathers along ``cuts``, ``((axes, dim), ...)`` in order,
    of ``x`` cast to ``dtype`` (None keeps it). The backward reduce-scatters
    the cuts in reverse, in float32 on the wire for a narrower gradient,
    and returns the sum in ``x``'s dtype."""

    @staticmethod
    def forward(ctx_, mesh, cuts, x, dtype):
        ctx_.mesh, ctx_.cuts, ctx_.in_dtype = mesh, cuts, x.dtype
        if dtype is not None:
            x = x.to(dtype)
        for axes, dim in cuts:
            if mesh.dry:
                x = torch.cat([x] * math.prod(mesh.shape[a] for a in axes), dim=dim)
                _tally("all-gather", x)
            else:
                x = _gather_tiled(mesh, axes, x, dim)
        return x

    @staticmethod
    def backward(ctx_, g):
        wide = g if g.dtype in (torch.float32, torch.float64) else g.float()
        for axes, dim in reversed(ctx_.cuts):
            wide = _PsumScatter.apply(ctx_.mesh, axes, wide, dim)
        return None, None, wide.to(ctx_.in_dtype), None


class _MeanGrad(torch.autograd.Function):
    """Identity forward; the backward averages the gradient over ``axes``
    (float32 on the wire, summed in rank order) and returns it in its
    dtype."""

    @staticmethod
    def forward(ctx_, mesh, axes, x):
        ctx_.mesh, ctx_.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        wide = g if g.dtype in (torch.float32, torch.float64) else g.float()
        n = math.prod(ctx_.mesh.shape[a] for a in ctx_.axes)
        if ctx_.mesh.dry:
            _tally("all-reduce", wide)
            return None, None, g
        return None, None, (_sum_over(ctx_.mesh, ctx_.axes, wide) / n).to(g.dtype)


def _swap(mesh: Mesh, axis: str, chunks: list[torch.Tensor]) -> list[torch.Tensor]:
    """Chunk j of ``chunks`` (host tensors as gloo moves them) to rank j of
    the ``axis`` line -> the chunks received, in sender order (this rank's
    own kept)."""
    me = axis_index(mesh, axis)
    line = mesh.line(axis)
    recv = [_host_like(chunks[me]) for _ in chunks]
    reqs = []
    for j, c in enumerate(chunks):
        if j == me:
            recv[j] = c
            continue
        reqs.append(dist.isend(c, line[j]))
        reqs.append(dist.irecv(recv[j], line[j]))
        TRAFFIC["sent_bytes"] += c.nbytes
    for r in reqs:
        r.wait()
    return recv


def _scatter_sum(mesh: Mesh, axes: tuple, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The reduce-scatter: per axis (the first varies slowest), block j of
    ``x`` along ``dim`` sent to rank j of the line, and the blocks received
    summed in rank order, so this rank's block of the sum over ``axes``
    has the bits of the whole sum's (:func:`_sum_over`)."""
    for a in axes:
        host = _wire(x)
        parts = [c if c.is_contiguous() else _host_like(host, c.shape).copy_(c)
                 for c in torch.chunk(host, mesh.shape[a], dim=dim)]
        got = [_cooked(r, parts[0]) for r in _swap(mesh, a, [_raw(p) for p in parts])]
        acc = torch.add(got[0], got[1], out=_host_like(host, got[0].shape))
        for p in got[2:]:  # rank order, in x's dtype
            acc += p
        x = _unwire(acc, x)
    return x


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, mesh, axes, x, dim):
        ctx_.mesh, ctx_.axes, ctx_.dim = mesh, axes, dim
        n = math.prod(mesh.shape[a] for a in axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {axes} ({n} blocks)")
        if mesh.dry:
            out = x.narrow(dim, 0, x.shape[dim] // n).clone()
            _tally("reduce-scatter", out)
            return out
        return _scatter_sum(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx_, g):
        return None, None, _AllGatherTiled.apply(ctx_.mesh, ((ctx_.axes, ctx_.dim),), g, None), None


def _exchange(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Chunk j of ``x``'s leading dim to rank j of the ``axis`` line; the
    chunks received, in sender order, concatenated along dim 0."""
    hosts = [_wire(c) for c in torch.chunk(x, mesh.shape[axis], dim=0)]
    recv = _swap(mesh, axis, [_raw(h) for h in hosts])
    return _unwire(torch.cat([_cooked(r, h) for r, h in zip(recv, hosts)], dim=0), x)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, mesh, axis, x):
        ctx_.mesh, ctx_.axis = mesh, axis
        if x.shape[0] % mesh.shape[axis]:
            raise ValueError(f"all_to_all: leading dim {x.shape[0]} does not split over {axis}")
        if mesh.dry:
            _tally("all-to-all", x)
            return x.clone()
        return _exchange(mesh, axis, x)

    @staticmethod
    def backward(ctx_, g):
        return None, None, _AllToAll.apply(ctx_.mesh, ctx_.axis, g)


class _KeepBlock(torch.autograd.Function):
    """This rank's block along ``dim`` over ``axes`` of a value the ranks
    of ``axes`` hold alike. The backward gives each rank the same share of
    the replicas' total, the blocks' gradients all-gathered and averaged
    over the ranks (as :class:`_MeanGrad` shares one): every rank then runs
    the backward of the whole computation on the whole gradient, rounding
    as one process does, and a later transpose (a gather's
    reduce-scatter) adds up equal shares."""

    @staticmethod
    def forward(ctx_, mesh, axes, x, dim):
        ctx_.mesh, ctx_.axes, ctx_.dim = mesh, axes, dim
        return _my_block(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx_, g):
        n = math.prod(ctx_.mesh.shape[a] for a in ctx_.axes)
        return None, None, _AllGatherTiled.apply(ctx_.mesh, ((ctx_.axes, ctx_.dim),), g, None) / n, None


def psum(mesh: Mesh, axes, x: torch.Tensor) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over the ranks of ``axes`` (a name or
    a tuple), summed in rank order, the same bits on every rank."""
    axes = _live(mesh, axes)
    return _Psum.apply(mesh, axes, x) if axes else x


def pmean(mesh: Mesh, axes, x: torch.Tensor) -> torch.Tensor:
    """``lax.pmean``: :func:`psum` over the axes' size."""
    live = _live(mesh, axes)
    return psum(mesh, live, x) / math.prod(mesh.shape[a] for a in live) if live else x


def pmax(mesh: Mesh, axes, x: torch.Tensor) -> torch.Tensor:
    """``lax.pmax``: the elementwise max over the ranks of ``axes``; no
    gradient passes (decode attention uses it as a shift that cancels)."""
    axes = _live(mesh, axes)
    x = x.detach()
    if not axes:
        return x
    if mesh.dry:
        _tally("all-reduce", x)
        return x.clone()
    for a in axes:
        x = _gather_stack(mesh, a, x).amax(0)
    return x


def all_gather_tiled(mesh: Mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: the blocks of ``axes``' ranks
    concatenated along ``dim`` in block order (row-major over ``axes``)."""
    axes = _live(mesh, axes)
    return _AllGatherTiled.apply(mesh, ((axes, dim),), x, None) if axes else x


def psum_scatter(mesh: Mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``lax.psum_scatter(..., tiled=True)``: the sum over ``axes``' ranks,
    of which this rank keeps its block along ``dim``."""
    axes = _live(mesh, axes)
    return _PsumScatter.apply(mesh, axes, x, dim) if axes else x


def mean_grad(mesh: Mesh, axes, x: torch.Tensor) -> torch.Tensor:
    """``x``, replicated over ``axes`` (a name or a tuple), as it is; its
    gradient, each rank's share of the replicas' total, is averaged over
    ``axes`` (float32 on the wire). The replicas' sum, all that a
    replicated value's gradient means here (``train.loop``), is kept, and
    the shares meet before a narrower dtype rounds them: the input of a
    tensor-parallel block's column-parallel matmuls."""
    axes = _live(mesh, axes)
    return _MeanGrad.apply(mesh, axes, x) if axes else x


def all_to_all(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)``: the leading dim in
    as many chunks as ``axis`` has ranks, chunk j sent to rank j; the
    received chunks concatenated in sender order."""
    return _AllToAll.apply(mesh, axis, x) if _live(mesh, axis) else x


def keep_block(mesh: Mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (a name or a
    tuple), ``x`` being a value those ranks compute alike (a slice whose
    backward averages the ranks' gradients, :class:`_KeepBlock`)."""
    axes = _live(mesh, axes)
    return _KeepBlock.apply(mesh, axes, x, dim) if axes else x


def block_index(mesh: Mesh, axes) -> int:
    """This rank's block of a dim split over ``axes`` (row-major, the first
    axis slowest; 0 where none is live)."""
    i = 0
    for a in _live(mesh, axes):
        i = i * mesh.shape[a] + axis_index(mesh, a)
    return i


def block_along(mesh: Mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (a slice; its
    gradient is zero outside the block)."""
    axes = _live(mesh, axes)
    return _my_block(mesh, axes, x, dim) if axes else x


def all_reduce_(mesh: Mesh, axes, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` in place over ``axes`` through the transport's own
    all-reduce in float32 (gradients: large tensors, one reduction a leaf);
    every rank of an axis line gets the same bits."""
    axes = _live(mesh, axes)
    if not axes:
        return t
    if mesh.dry:
        _tally("all-reduce", t)
        return t
    buf = _wire(t.float())
    for a in axes:
        dist.all_reduce(buf, group=mesh.groups[a])
        TRAFFIC["sent_bytes"] += buf.nbytes
    t.copy_(_unwire(buf, t))
    return t
