"""Live ICU monitoring path: rolling AHE prediction over a streaming DSLSH.

Counterpart of ``repro.stream.monitor``. ``StreamingMonitor`` replays
timestamped ABP lag windows (``data/abp`` + ``data/windows``) as a stream
through a :class:`~repro_torch.stream.shard.ShardedStream` core: each
arriving batch is first classified (rolling AHE prediction with per-event
latency), then ingested — queryable immediately, no rebuild. Nodes
compact when their delta segments fill; under a retention horizon
compaction also evicts stale windows and the monitor renumbers its labels
along the core's :class:`~repro_torch.stream.shard.IngestReport.keep` map.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import distributed as D
from repro_torch.core import pipeline, routing
from repro_torch.core import predict as predict_mod
from repro_torch.stream.shard import (  # noqa: F401  (re-exported public API)
    CellState,
    NodeState,
    ShardedStream,
    node_init,
)


@dataclasses.dataclass
class StreamEvent:
    """One replay step: predictions for the arriving windows, then ingest."""

    t: float  # stream timestamp of the batch
    node: int  # node the batch was routed to
    inserted: int  # windows absorbed into the node's delta segment
    dropped: int  # windows dropped (delta + store both full)
    compacted: bool  # node compacted before this ingest
    evicted: int  # stale windows evicted during that compaction
    preds: list  # AHE predictions for the arriving windows (pre-ingest)
    labels: list  # ground-truth labels for the same windows
    latency_s: float  # wall-clock latency of the prediction query (synced)
    comparisons: float  # median per-cell unique candidates scanned
    overflow: int  # (cell, query) partials whose c_comp budget overflowed
    n_index: int  # points queryable across all nodes after ingest
    # fraction of (cell, query) pairs the router visited (1.0 when routing
    # is off: every pair probed)
    routed_frac: float = 1.0


class StreamingMonitor:
    """Replay a timestamped window stream through a sharded streaming DSLSH.

    ``key`` names the root hash family as in
    :class:`~repro_torch.stream.shard.ShardedStream`; the state lives on
    ``device`` (the card unless told otherwise).

    >>> import numpy as np
    >>> from repro_torch.core import distributed as D
    >>> cfg = pipeline.SLSHConfig.compose(m_out=8, L_out=4, m_in=4, L_in=2,
    ...     alpha=0.05, k=3, val_lo=0.0, val_hi=1.0, c_max=16, c_in=8,
    ...     h_max=2, p_max=32, query_chunk=8, use_inner=False, backend="torch")
    >>> pts = np.random.default_rng(0).uniform(0, 1, (32, 8)).astype(np.float32)
    >>> mon = StreamingMonitor(0, pts, np.zeros(32, np.int8), cfg, D.Grid(nu=1, p=1),
    ...                        node_capacity=64, delta_cap=16, device="cpu")
    >>> ev = mon.step(pts[:4], np.zeros(4, np.int8), t=1.0)
    >>> (ev.inserted, ev.dropped, len(ev.preds))
    (4, 0, 4)
    >>> mon.n_index()
    36
    """

    def __init__(
        self,
        key,
        init_points,
        init_labels,
        cfg: pipeline.SLSHConfig,
        grid: D.Grid,
        *,
        node_capacity: int,
        delta_cap: int,
        retention_s: float = float("inf"),
        label_delay_s: float = 0.0,
        t0: float = 0.0,
        route: bool = True,
        route_bits: int = routing.DEFAULT_BITS,
        obs: obs_mod.Obs | None = None,
        device: str | torch.device | None = None,
    ):
        """``label_delay_s``: how long after ingestion a window's AHE label
        becomes observable (its condition window must close first). Until
        then a streamed window votes as non-AHE (label 0); 0 attaches labels
        at once. Warm-up labels attach at once either way.

        ``route`` applies the key→cell router to every prediction query
        (exact: the same predictions, fewer cells visited). ``obs``
        instruments the monitor: every :meth:`step` activates the bundle,
        so predictions feed the predict-latency histogram and routed_frac
        and the core's ingest feeds the stream counters (DESIGN.md §12)."""
        init_points = np.asarray(init_points, np.float32)
        init_labels = np.asarray(init_labels)
        n0 = init_points.shape[0]
        self.core = ShardedStream(
            key, init_points, cfg, grid,
            node_capacity=node_capacity, delta_cap=delta_cap,
            retention_s=retention_s, t0=t0, route=route, route_bits=route_bits,
            device=device,
        )
        self.cfg, self.grid = cfg, grid
        self.obs = obs
        self.node_capacity = node_capacity
        self.label_delay_s = label_delay_s
        self.last_routed_frac = 1.0
        self._pending_labels: list[tuple[float, int, np.ndarray, np.ndarray]] = []
        self.events: list[StreamEvent] = []
        n_loc = n0 // grid.nu
        self.labels = np.zeros((grid.nu, node_capacity), np.int8)
        for i in range(grid.nu):
            self.labels[i, :n_loc] = init_labels[i * n_loc : (i + 1) * n_loc]

    # ------------------------------------------------------- core plumbing

    @property
    def state(self) -> list[NodeState]:
        """The core's per-node state list (shared, not copied)."""
        return self.core.state

    @property
    def _query(self):
        """The core's query program ``(state, q) -> (kd, ki, comparisons,
        overflow, routed)``, exposed for equivalence tests."""
        return self.core._query

    def n_index(self) -> int:
        """Points queryable right now, across all nodes."""
        return self.core.n_index()

    def _maintain_node(self, node_idx: int, t: float) -> int:
        """Compact/evict one node now and renumber labels along the core's
        keep map; returns the evicted-window count."""
        evicted, keep = self.core.maintain(node_idx, t)
        if keep is not None:
            self._renumber_labels(node_idx, keep)
        return evicted

    # ------------------------------------------------------------- labels

    def flush_labels(self, now: float) -> None:
        """Attach pending labels whose condition windows have closed."""
        still = []
        for reveal_t, node_idx, slots, labs in self._pending_labels:
            if reveal_t <= now:
                self.labels[node_idx, slots] = labs
            else:
                still.append((reveal_t, node_idx, slots, labs))
        self._pending_labels = still

    def _renumber_labels(self, node_idx: int, keep_np: np.ndarray) -> None:
        """Apply an eviction's surviving-row map to this node's labels and
        pending label slots (old row ``keep[i]`` became row ``i``)."""
        relab = np.zeros((self.node_capacity,), np.int8)
        relab[: keep_np.shape[0]] = self.labels[node_idx, keep_np]
        self.labels[node_idx] = relab
        remapped = []
        for reveal_t, nd, slots, labs in self._pending_labels:
            if nd == node_idx:
                pos = np.searchsorted(keep_np, slots)
                ok = (pos < keep_np.shape[0]) & (
                    keep_np[np.minimum(pos, keep_np.shape[0] - 1)] == slots
                )
                if not ok.any():
                    continue
                slots, labs = pos[ok], labs[ok]
            remapped.append((reveal_t, nd, slots, labs))
        self._pending_labels = remapped

    # ------------------------------------------------------------- stream

    def ingest(self, points, labels, t: float) -> dict:
        """Route one window batch to the next node; auto-compact on pressure."""
        self.flush_labels(t)
        labels = np.asarray(labels)
        rep = self.core.ingest(points, t)
        if rep.keep is not None:
            self._renumber_labels(rep.node, rep.keep)
        if self.label_delay_s > 0:
            # the condition window has not closed yet: reveal the label only
            # once it is observable
            self._pending_labels.append(
                (t + self.label_delay_s, rep.node, rep.slots, labels[: rep.inserted].copy())
            )
        else:
            self.labels[rep.node, rep.slots] = labels[: rep.inserted]
        return dict(
            node=rep.node, inserted=rep.inserted, dropped=rep.dropped,
            compacted=rep.compacted, evicted=rep.evicted,
        )

    def predict(self, queries) -> tuple[np.ndarray, float, float, int]:
        """AHE predictions for ``queries`` against the live sharded index.

        Returns (predictions, latency seconds with the device synchronized,
        median per-cell comparisons, count of (cell, query) partials whose
        compaction budget overflowed). ``self.last_routed_frac`` holds the
        fraction of (cell, query) pairs the router visited."""
        dev = self.core.device
        with obs_mod.timed_section("stream.predict") as sec:
            res = self.core.query(queries)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        latency = sec.dur_s
        self.last_routed_frac = res.routed_frac
        ob = self.obs if self.obs is not None else obs_mod.get_active()
        if ob is not None and ob.metrics is not None:
            m = ob.metrics
            m.histogram(
                "dslsh_stream_predict_latency_seconds",
                "wall time of one rolling AHE prediction query (synced)",
            ).observe(latency)
            m.histogram(
                "dslsh_routed_frac",
                "fraction of (cell, query) pairs the §10 router visited",
                buckets=obs_mod.log_buckets(0.01, 1.0, per_decade=8),
            ).observe(float(res.routed_frac))
        labels = torch.as_tensor(self.labels.reshape(-1), device=dev)
        preds = predict_mod.predict_batch(labels, res.knn_idx, res.knn_dist)
        return (
            preds.cpu().numpy(), latency,
            float(np.median(res.comparisons.cpu().numpy())),
            res.overflow_cells,
        )

    def step(self, points, labels, t: float, *, predict: bool = True) -> StreamEvent:
        """One monitoring step: predict on the arriving windows, then ingest."""
        ctx = self.obs.activate() if self.obs is not None else contextlib.nullcontext()
        with ctx:
            return self._step_impl(points, labels, t, predict=predict)

    def _step_impl(self, points, labels, t: float, *, predict: bool) -> StreamEvent:
        preds, latency, comps, overflow = (np.zeros((0,), np.int32), 0.0, 0.0, 0)
        routed_frac = 1.0
        if predict:
            self.flush_labels(t)  # reveal labels observable by now, no later ones
            preds, latency, comps, overflow = self.predict(points)
            routed_frac = self.last_routed_frac
        info = self.ingest(points, labels, t)
        ev = StreamEvent(
            t=float(t), node=info["node"], inserted=info["inserted"],
            dropped=info["dropped"], compacted=info["compacted"],
            evicted=info["evicted"], preds=np.asarray(preds).tolist(),
            labels=np.asarray(labels).tolist(), latency_s=latency,
            comparisons=comps, overflow=overflow, n_index=self.n_index(),
            routed_frac=routed_frac,
        )
        self.events.append(ev)
        return ev

    def replay(
        self, points, labels, ts, *, batch_size: int = 8, predict_every: int = 1
    ) -> list[StreamEvent]:
        """Replay a whole timestamped window stream; returns its events."""
        points = np.asarray(points, np.float32)
        labels = np.asarray(labels)
        ts = np.asarray(ts, np.float64)
        out = []
        for step_i, s in enumerate(range(0, points.shape[0], batch_size)):
            e = min(s + batch_size, points.shape[0])
            do_pred = predict_every > 0 and step_i % predict_every == 0
            out.append(self.step(points[s:e], labels[s:e], float(ts[e - 1]), predict=do_pred))
        return out

    def mcc(self) -> float:
        """MCC over every rolling prediction emitted so far."""
        preds = [p for ev in self.events for p in ev.preds]
        trues = [t for ev in self.events if ev.preds for t in ev.labels]
        if not preds:
            return 0.0
        return float(predict_mod.mcc(torch.as_tensor(preds), torch.as_tensor(trues[: len(preds)])))
