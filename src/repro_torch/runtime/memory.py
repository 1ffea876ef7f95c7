"""Per-cell index memory accountant (DESIGN.md §13).

Counterpart of ``repro.runtime.memory``, without its obs gauge (the port has
no ``obs`` yet). Answers "what does one cell's index cost to hold
resident?" from tensor shapes alone, without a device sync. An
:class:`~repro_torch.core.pipeline.SLSHIndex` splits into the components a
capacity plan budgets:

* ``tables`` — the outer CSR pair ``sorted_keys``/``sorted_idx`` (L, n);
* ``heavy``  — the heavy-bucket directory;
* ``inner``  — stratified inner tables over heavy buckets (L, H, L_in, P);
* ``data``   — the exact f32 rows the distance and rerank stages gather;
* ``payload`` — the optional quantized payload and its per-row meta
  (zero when ``cfg.payload == "f32"``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.runtime.payload import _META_COLS, payload_itemsize

COMPONENTS = ("tables", "heavy", "inner", "data", "payload")


def tree_nbytes(tree) -> int:
    """Total bytes of every tensor in ``tree`` (a tensor, or a tuple, list or
    NamedTuple nesting them; other leaves count 0)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(t) for t in tree)
    return 0


class MemoryReport(NamedTuple):
    """Byte accounting for one index: totals plus the per-cell split.

    ``components`` maps each :data:`COMPONENTS` name to total bytes over all
    cells; ``cells`` is the ``(nu, p)`` grid the totals divide over
    (``(1, 1)`` for a single shard). Cells have equal shapes, so per-cell
    bytes are exact shares.
    """

    components: dict[str, int]
    cells: tuple[int, int]

    @property
    def total(self) -> int:
        """Total resident bytes across every component and cell."""
        return sum(self.components.values())

    @property
    def per_cell(self) -> dict[str, int]:
        """Component bytes for one cell (totals / nu*p)."""
        k = self.cells[0] * self.cells[1]
        return {name: b // k for name, b in self.components.items()}

    def to_dict(self) -> dict:
        """JSON-ready form for reports."""
        return {
            "cells": list(self.cells),
            "total_bytes": self.total,
            "components": dict(self.components),
            "per_cell": self.per_cell,
        }

    def feed_gauges(self, metrics) -> None:
        """Set ``dslsh_index_bytes{component,cell}`` on a metrics registry:
        one sample per (component, cell), each cell its equal share."""
        fam = metrics.gauge(
            "dslsh_index_bytes",
            "resident index bytes by component per (node/core) cell"
            " (DESIGN.md §13 capacity accounting)",
        )
        per = self.per_cell
        for j in range(self.cells[0]):
            for c in range(self.cells[1]):
                for name, b in per.items():
                    fam.labels(component=name, cell=f"{j}/{c}").set(float(b))


def payload_nbytes(n: int, d: int, fmt: str) -> int:
    """Bytes of the quantized payload for ``n`` rows of width ``d`` in
    format ``fmt`` (0 for ``"f32"``: the exact rows, counted under
    ``data``, serve directly).

    >>> payload_nbytes(1000, 30, "f32")
    0
    >>> payload_nbytes(1000, 30, "i8")  # 30 i8 + 2 f32 meta per row
    38000
    """
    if fmt == "f32":
        return 0
    return n * (d * payload_itemsize(fmt) + _META_COLS * 4)


def index_report(index, data: torch.Tensor, fmt: str = "f32", cells=(1, 1)) -> MemoryReport:
    """Account an index and its dataset -> :class:`MemoryReport`.

    ``index`` is one ``SLSHIndex`` or a list of cell indexes (a grid);
    ``data`` is the dataset the handle keeps resident; ``fmt`` is
    ``cfg.payload`` and adds the payload component when not ``"f32"``.
    """
    parts = index if isinstance(index, list) else [index]
    data_bytes = tree_nbytes(data)
    d = data.shape[-1]
    return MemoryReport(
        components={
            "tables": sum(tree_nbytes(ix.outer) for ix in parts),
            "heavy": sum(tree_nbytes(ix.heavy) for ix in parts),
            "inner": sum(tree_nbytes((ix.inner_keys, ix.inner_idx)) for ix in parts),
            "data": data_bytes,
            "payload": payload_nbytes(data_bytes // (d * data.element_size()), d, fmt),
        },
        cells=(int(cells[0]), int(cells[1])),
    )
