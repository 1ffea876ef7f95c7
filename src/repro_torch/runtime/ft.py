"""Fault tolerance: heartbeats, straggler deadlines, elastic re-sharding
(the counterpart of ``repro.runtime.ft``).

The DSLSH serving path is embarrassingly data-parallel (the paper's nodes
hold disjoint slices), so the recovery story is:

* **Heartbeats / failure detection** — :class:`HeartbeatMonitor` tracks
  per-node liveness (simulated here; on a real cluster this is the
  coordinator service). Missed deadline => node marked down.
* **Straggler mitigation (serving)** — the Reducer proceeds with a
  ``drop_mask`` excluding late nodes (``index.query(q, drop_mask=...)``,
  on a grid or a mesh):
  bounded tail latency at a small recall cost, the paper's latency-first
  design.
* **Elastic repair** — on permanent failure the lost nodes' cells are
  rebuilt in place from the hash-family parameters each cell already holds
  (:func:`elastic_restore_cells`); the surviving cells are reused as they
  are.
* **Retry wrapper** — transient errors retry with exponential backoff.

The JAX package's ``simulate_training_failure_and_restart`` waits for the
port's training slice (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.obs import clock


@dataclasses.dataclass
class HeartbeatMonitor:
    """Per-node liveness from heartbeats against a deadline.

    A node that has never beaten is measured from ``start`` (monitor
    creation), not from the beginning of time: a fresh monitor grants
    every node one full ``deadline_s`` of grace before declaring it down,
    so the first ``drop_mask()`` after a monitor swap never reports a
    phantom total outage. Pass ``start`` explicitly when driving the
    monitor on a simulated clock.
    """

    n_nodes: int
    deadline_s: float = 1.0
    last_beat: dict = dataclasses.field(default_factory=dict)
    start: float | None = None

    def __post_init__(self):
        if self.start is None:
            self.start = clock.monotonic()

    def beat(self, node: int, t: float | None = None):
        """Record liveness for ``node`` on the monotonic clock (a wall-clock
        jump must never mark a live node down); pass ``t`` only with a
        consistent simulated clock."""
        self.last_beat[node] = clock.monotonic() if t is None else t

    def down_nodes(self, now: float | None = None) -> list[int]:
        """Nodes whose last beat (or the monitor's start) is older than the
        deadline at ``now``."""
        now = clock.monotonic() if now is None else now
        return [
            n
            for n in range(self.n_nodes)
            if now - self.last_beat.get(n, self.start) > self.deadline_s
        ]

    def drop_mask(self, now: float | None = None) -> np.ndarray:
        """``(n_nodes,)`` bool mask of the nodes down at ``now``."""
        mask = np.zeros(self.n_nodes, bool)
        mask[self.down_nodes(now)] = True
        return mask


def retry(fn: Callable, attempts: int = 3, backoff_s: float = 0.05):
    """Retry transient failures with exponential backoff."""

    def wrapped(*a, **kw):
        err = None
        for i in range(attempts):
            try:
                return fn(*a, **kw)
            except Exception as e:  # noqa: BLE001
                err = e
                time.sleep(backoff_s * (2**i))
        raise err

    return wrapped


def elastic_reshard_dslsh(seed, points, labels, cfg, old_grid, failed_nodes: list[int], *,
                          device: str | torch.device | None = None):
    """Rebuild the DSLSH deployment over the surviving nodes after permanent
    node failures: they re-partition the full dataset and rebuild their
    tables from the SAME root family (``seed``: an int, or an ``(outer,
    inner)`` pair as ``pipeline.family_from_key`` takes), so queries stay
    exactly comparable. Returns ``(new_grid, new_index, padded_points,
    padded_labels, n_real)``, the index the cell list of
    ``core.distributed.simulate_build`` on ``device`` (the card unless told
    otherwise)."""
    from repro_torch import device as device_mod
    from repro_torch.core import distributed as D
    from repro_torch.core import pipeline

    nu_new = old_grid.nu - len(failed_nodes)
    if nu_new < 1:
        raise ValueError("no surviving nodes")
    grid = D.Grid(nu=nu_new, p=old_grid.p)
    pts, labs, n_real = D.pad_to_multiple(np.asarray(points), np.asarray(labels), grid.cells)
    dev = device_mod.resolve(device)
    pts_t = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    family = pipeline.family_from_key(seed, pts.shape[1], cfg, dev)
    index = D.simulate_build(family, pts_t, cfg, grid)
    return grid, index, pts_t, torch.as_tensor(labs, device=dev), n_real


def elastic_restore_cells(index, failed_nodes: list[int]):
    """Rebuild only the failed nodes' cells of a grid ``dslsh`` handle.

    The replacement hosts re-read the lost slice from the durable store
    (here: the handle's own resident data tensor) and rebuild each of
    their ``p`` cells with ``pipeline.build_from_params`` **from the
    hash-family parameters that cell already holds** — no root seed is
    needed, and the surviving cells' tensors are reused by reference. The
    restored handle answers queries bit-identically to the original (same
    family, same data, same construction path): the repair primitive of
    the elastic controller (DESIGN.md §14).

    Returns a new :class:`repro_torch.api.Index`; the input is unchanged.
    """
    from repro_torch import api
    from repro_torch.core import pipeline

    pipeline._require(
        index.deploy.kind == "grid",
        "elastic_restore_cells repairs grid deployments — streaming"
        " state lives in per-node delta segments (DESIGN.md §9)",
    )
    failed = sorted(set(int(j) for j in failed_nodes))
    nu, p = index.deploy.nu, index.deploy.p
    if not all(0 <= j < nu for j in failed):
        raise ValueError(f"failed nodes {failed} out of range for nu={nu}")
    if not failed:
        return index
    cells = list(index._state["index"])  # flat (node, core) order
    data = index._state["data"]
    n_loc = data.shape[0] // nu
    for j in failed:
        data_local = data[j * n_loc : (j + 1) * n_loc]
        for c in range(p):
            old = cells[j * p + c]
            cells[j * p + c] = pipeline.build_from_params(data_local, old.outer_params, old.inner_params, index.cfg)
    return api.Index(index.deploy, index.cfg, {**index._state, "index": cells}, obs=index._obs)


def elastic_reshard_index(seed, points, labels, cfg, deploy, failed_nodes: list[int], *,
                          device: str | torch.device | None = None):
    """Deployment-API reshard after permanent node failures.

    Pass the live ``dslsh`` grid handle as ``deploy`` and the failed nodes'
    cells are rebuilt **in place on the same grid** via
    :func:`elastic_restore_cells`: the surviving cells are reused and the
    result answers bit-identically to the pre-failure index. Returns
    ``(index, labels, n_real)`` with ``labels`` padded to the handle's grid
    (a tensor on the handle's device).

    Passing a :class:`repro_torch.api.Deployment` descriptor instead keeps
    the legacy behaviour — shrink the grid by ``len(failed_nodes)`` and
    rebuild every cell from the root family ``seed`` (as
    :func:`elastic_reshard_dslsh` takes it) on ``device`` — and warns: the
    full rebuild pays the whole construction cost to recover a sliver of
    it.
    """
    from repro_torch import api
    from repro_torch import device as device_mod

    if isinstance(deploy, api.Index):
        index = elastic_restore_cells(deploy, failed_nodes)
        _, labs, n_real = api.pad_to_multiple(np.asarray(points), np.asarray(labels), index.deploy.cells)
        return index, torch.as_tensor(labs, device=index.device), n_real

    warnings.warn(
        "elastic_reshard_index(deploy=Deployment) rebuilds every cell from"
        " scratch; pass the live Index handle to reuse surviving cells",
        DeprecationWarning,
        stacklevel=2,
    )
    nu_new = deploy.nu - len(failed_nodes)
    if nu_new < 1:
        raise ValueError("no surviving nodes")
    new_deploy = api.grid(nu=nu_new, p=deploy.p, replication=deploy.replication, routed=deploy.routed)
    pts, labs, n_real = api.pad_to_multiple(np.asarray(points), np.asarray(labels), new_deploy.cells)
    dev = device_mod.resolve(device)
    index = api.build(seed, pts, cfg, new_deploy, dev)
    return index, torch.as_tensor(labs, device=dev), n_real
