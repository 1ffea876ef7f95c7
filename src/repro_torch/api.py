"""One typed DSLSH handle — the port's ``dslsh`` Deployment API.

Counterpart of ``repro.api`` for the :func:`single` and :func:`grid`
deployments. A frozen :class:`Deployment` says where the index runs, and
one handle runs the lifecycle::

    cfg = dslsh.make_config(dslsh.FamilyConfig(...), dslsh.BudgetConfig(...))
    index = dslsh.build(seed, data, cfg, dslsh.grid(nu=2, p=8))
    res = index.query(queries)          # one typed DistributedQueryResult

Everything runs on the CUDA card unless ``device="cpu"`` is passed. A
compressed payload (``payload="f16"``/``"i8"``) rides the single-shard
fused tail; a grid refuses it. Routed and replicated grids, the mesh and
streaming deployments, and persistence are not ported yet; they raise
``NotImplementedError`` (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as device_mod
from repro_torch import params as params_mod
from repro_torch.core import distributed as D
from repro_torch.core import hashing, pipeline
from repro_torch.core.distributed import (  # noqa: F401  (re-exported public API)
    DistributedQueryResult,
    Grid,
    pad_to_multiple,
    pknn_query,
)
from repro_torch.core.pipeline import (  # noqa: F401  (re-exported public API)
    BudgetConfig,
    ConfigError,
    FamilyConfig,
    RuntimeConfig,
    SLSHConfig,
)
from repro_torch.runtime import memory as memory_mod
from repro_torch.runtime import payload as payload_mod

__all__ = [
    "BudgetConfig",
    "ConfigError",
    "Deployment",
    "DistributedQueryResult",
    "FamilyConfig",
    "Grid",
    "Index",
    "RuntimeConfig",
    "SLSHConfig",
    "build",
    "grid",
    "load",
    "make_config",
    "mesh",
    "pad_to_multiple",
    "pknn_query",
    "single",
    "streaming",
]

_KINDS = ("single", "grid")
_NOT_PORTED = "is not ported to PyTorch yet (see ROADMAP.md, Queue 1)"


def make_config(
    family: FamilyConfig | None = None,
    budget: BudgetConfig | None = None,
    runtime: RuntimeConfig | None = None,
    **overrides,
) -> SLSHConfig:
    """Compose a validated :class:`SLSHConfig` from its three parts; flat
    field names in ``overrides`` route to the matching sub-config."""
    return SLSHConfig.compose(family, budget, runtime, **overrides)


@dataclasses.dataclass(frozen=True)
class Deployment:
    """Frozen descriptor of where a DSLSH index runs; build one with
    :func:`single` or :func:`grid`."""

    kind: str
    nu: int = 1  # nodes
    p: int = 1  # cores per node

    def __post_init__(self):
        pipeline._require(
            self.kind in _KINDS,
            f"unknown deployment kind {self.kind!r}; one of {_KINDS}",
        )
        pipeline._require(
            self.nu >= 1 and self.p >= 1,
            f"nu={self.nu}, p={self.p}: the cell grid needs at least one"
            " node and one core",
        )

    @property
    def grid(self) -> Grid:
        """The nu x p cell grid this deployment maps onto."""
        return Grid(nu=self.nu, p=self.p)

    @property
    def cells(self) -> int:
        """Total SLSH cells (the paper's nu*p)."""
        return self.nu * self.p


def single() -> Deployment:
    """One shard on one device — the paper's single-node path."""
    return Deployment(kind="single")


def grid(
    nu: int = 1,
    p: int = 1,
    *,
    replication: int = 1,
    routed: bool | None = None,
    degrade: tuple | None = None,
) -> Deployment:
    """The nu x p cell grid simulated on one device. Routing, replication
    and deadline degradation are not ported yet and raise."""
    if routed or replication > 1 or degrade is not None:
        raise NotImplementedError(f"routed/replicated grid deployment {_NOT_PORTED}")
    return Deployment(kind="grid", nu=nu, p=p)


def mesh(*args, **kwargs) -> Deployment:
    """The grid over a device mesh (``torch.distributed``): not ported yet."""
    raise NotImplementedError(f"the mesh deployment {_NOT_PORTED}")


def streaming(*args, **kwargs) -> Deployment:
    """The online ingest/compact deployment: not ported yet."""
    raise NotImplementedError(f"the streaming deployment {_NOT_PORTED}")


def load(path: str, **kwargs):
    """Restore a saved index: persistence is not ported yet."""
    raise NotImplementedError(f"load {_NOT_PORTED}")


class Index:
    """The typed DSLSH handle: deployment, config and built state.

    :meth:`query` always returns one :class:`DistributedQueryResult`,
    whatever the deployment; the handle adds no math of its own.
    """

    def __init__(self, deploy: Deployment, cfg: SLSHConfig, state: dict):
        self.deploy = deploy
        self.cfg = cfg
        self._state = state
        self._cached_payload: payload_mod.Payload | None = None

    @property
    def grid(self) -> Grid:
        """The deployment's cell grid."""
        return self.deploy.grid

    @property
    def device(self) -> torch.device:
        """The device the index lives on."""
        return self._state["data"].device

    @property
    def pipeline_index(self):
        """The built pipeline state: one ``SLSHIndex`` (single) or the cell
        indexes in flat (node, core) order (grid)."""
        return self._state["index"]

    def memory_report(self) -> memory_mod.MemoryReport:
        """Per-cell byte accounting of the resident index (DESIGN.md §13):
        tables, heavy, inner, data and payload bytes from tensor shapes
        alone, with no sync."""
        cells = (1, 1) if self.deploy.kind == "single" else (self.deploy.nu, self.deploy.p)
        return memory_mod.index_report(
            self._state["index"], self._state["data"], self.cfg.payload, cells
        )

    def _payload(self) -> payload_mod.Payload | None:
        """The handle's quantized candidate payload, made once and cached
        (None for ``payload='f32'``: the exact rows serve directly)."""
        if self.cfg.payload == "f32":
            return None
        if self._cached_payload is None:
            self._cached_payload = payload_mod.make_payload(self._state["data"], self.cfg.payload)
        return self._cached_payload

    def query(self, queries, *, drop_mask=None, drop_cells=None) -> DistributedQueryResult:
        """Resolve a query batch -> one :class:`DistributedQueryResult`.

        ``drop_mask`` (nu,) excludes straggler nodes from the Reducer and
        ``drop_cells`` (nu, p) lost cells (grid deployments).
        """
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        data, index = self._state["data"], self._state["index"]
        if self.deploy.kind == "single":
            pipeline._require(
                drop_mask is None and drop_cells is None,
                "drop_mask / drop_cells only apply to grid deployments (a"
                " single shard has no nodes or cells to drop)",
            )
            res = pipeline.query_batch(index, data, queries, self.cfg, self._payload())
            return DistributedQueryResult(
                res.knn_dist,
                res.knn_idx,
                res.comparisons[None, None],
                res.compaction_overflow[None, None],
                torch.ones((1, 1, queries.shape[0]), dtype=torch.bool, device=self.device),
                None if res.rerank_misses is None else res.rerank_misses[None, None],
            )
        return D.grid_query(
            index, data, queries, self.cfg, self.grid,
            drop_mask=drop_mask, drop_cells=drop_cells,
        )

    def save(self, path: str) -> str:
        """Persist the index: not ported yet."""
        raise NotImplementedError(f"Index.save {_NOT_PORTED}")


def _family(seed: int, d: int, cfg: SLSHConfig, dev: torch.device, params):
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        return pipeline.make_family(gen, d, cfg, dev)
    outer, inner = params
    if isinstance(outer, hashing.BitSampleParams) and isinstance(inner, hashing.SignRPParams):
        return (
            hashing.BitSampleParams(*(t.to(dev) for t in outer)),
            hashing.SignRPParams(*(t.to(dev) for t in inner)),
        )
    return params_mod.from_jax_params(outer, inner, dev)


def build(
    seed: int,
    data,
    cfg: SLSHConfig,
    deploy: Deployment,
    device: str | torch.device | None = None,
    *,
    params=None,
) -> Index:
    """Build a DSLSH index over ``data`` (n, d) for ``deploy`` -> :class:`Index`.

    ``seed`` draws the one root hash family every cell slices its tables
    from; ``params`` instead supplies it as an ``(outer, inner)`` pair —
    the port's parameter types, or numpy arrays such as the JAX package's
    family (see ``repro_torch.params``). For grid deployments ``n`` must
    divide the cell grid (:func:`pad_to_multiple`). Runs on the CUDA card
    unless ``device`` says otherwise.
    """
    dev = device_mod.resolve(device)
    data = torch.as_tensor(data, dtype=torch.float32, device=dev).contiguous()
    n, d = data.shape
    family = _family(seed, d, cfg, dev, params)
    if deploy.kind == "single":
        index = pipeline.build_from_params(data, *family, cfg)
        return Index(deploy, cfg, {"index": index, "data": data})
    pipeline._require(
        cfg.payload == "f32",
        f"payload={cfg.payload!r} (compressed candidate payload) rides"
        " the single-shard fused tail — grid/mesh/streaming"
        " deployments need payload='f32' (DESIGN.md §13)",
    )
    pipeline._require(
        cfg.L_out % deploy.p == 0,
        f"L_out={cfg.L_out} does not divide across p={deploy.p} cores"
        " (paper: each core owns L_out/p tables) — adjust L_out or p",
    )
    pipeline._require(
        n % deploy.nu == 0,
        f"n={n} does not divide across nu={deploy.nu} nodes — pad the"
        " dataset first (dslsh.pad_to_multiple(points, labels,"
        f" {deploy.cells}))",
    )
    index = D.simulate_build(family, data, cfg, deploy.grid)
    return Index(deploy, cfg, {"index": index, "data": data})

