"""Async multi-tenant serving front end over ``dslsh.Index`` (DESIGN.md §15);
the counterpart of ``repro.serve.frontend``.

This is the path from "millions of users" to the query core: the
paper's service is latency-first ("our implementation ... prioritizes
latency over throughput"), and this module supplies everything between a
tenant's request and the static-shape query pipeline:

1. **Admission** (`serve/admission.py`): per-tenant token buckets decide
   ADMIT / DEGRADE / SHED before any compute is spent; shed load is
   counted and returned with explicit backpressure, never dropped.
2. **Coalescing** (`serve/coalesce.py`): queued requests pack whole into
   micro-batches padded to a fixed bucket ladder, so steady-state
   serving launches a bounded set of kernel shapes
   (``obs.query_retraces()``, the port's kernel-library builds and
   streaming program constructions, stays flat after
   :meth:`ServeFrontend.warmup`).
3. **Deadline scheduling**: the queue orders by slack
   (earliest-deadline-first); each micro-batch's ``max_cells`` routing
   cap comes from the *tightest* deadline in it via
   ``routing.degrade_max_cells`` — degraded responses carry the flag,
   exact responses are bit-identical to a direct ``Index.query``.
4. **Query/ingest concurrency**: streaming ingest is RCU — it builds the
   next state aside on an :class:`~repro_torch.runtime.elastic.Epoch`
   snapshot and publishes with one reference swap, so an
   in-flight micro-batch never observes a half-applied compaction.

The core is a deterministic state machine (submit / pump on an injected
monotonic clock, so a chaos schedule replays exactly); :class:`AsyncFrontend`
wraps it in an asyncio event loop for callers that want awaitable
responses with ingest running between micro-batches.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import routing
from repro_torch.obs import clock
from repro_torch.runtime import elastic as elastic_mod
from repro_torch.serve import admission as admission_mod
from repro_torch.serve import coalesce as coalesce_mod


@dataclasses.dataclass
class ServeRequest:
    """One tenant request riding the front end, cradle to grave.

    ``queries`` is the tenant's (nq, d) batch; ``deadline_s`` is the SLA
    measured from ``submitted_at`` (monotonic — queued time counts).
    ``status`` walks ``queued → done | timed_out`` (or ``shed`` straight
    from admission); ``degraded`` is True iff the response was served
    under a §10 ``max_cells`` cap or with lost cells — an undegraded
    ``done`` response is bit-identical to a solo ``Index.query``.
    """

    rid: int
    tenant: str
    queries: np.ndarray  # (nq, d) float32
    deadline_s: float = math.inf
    submitted_at: float = 0.0
    verdict: str | None = None  # admission outcome (None before submit)
    status: str = "new"  # new | queued | shed | done | timed_out
    degraded: bool = False
    max_cells: int | None = None  # routing cap the batch was served under
    epoch: int | None = None  # serving epoch the answer came from
    knn_dist: np.ndarray | None = None  # (nq, K)
    knn_idx: np.ndarray | None = None  # (nq, K)
    latency_s: float = 0.0  # submit → finalize (monotonic)

    @property
    def deadline_at(self) -> float:
        """Absolute monotonic deadline (submission-relative, §15)."""
        return self.submitted_at + self.deadline_s

    @property
    def n_queries(self) -> int:
        """Query rows this request carries."""
        return int(self.queries.shape[0])


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Front-end knobs (DESIGN.md §15).

    ``ladder`` — the pad-to-bucket micro-batch sizes (`serve/coalesce.py`).
    ``max_queue`` — global queued-query bound; beyond it admission sheds
    with backpressure. ``degrade`` — deadline-degradation levels
    ``((min_slack_s, max_cells), ...)`` mapped through
    ``routing.degrade_max_cells`` from each micro-batch's tightest slack
    (requires a routed deployment; None disables degradation — requests
    then either make their deadline exactly or time out, flagged).
    ``quotas`` / ``default_quota`` — per-tenant admission limits.
    """

    ladder: tuple[int, ...] = coalesce_mod.BUCKET_LADDER
    max_queue: int = 4096
    degrade: tuple[tuple[float, int | None], ...] | None = None
    quotas: tuple[tuple[str, admission_mod.TenantQuota], ...] = ()
    default_quota: admission_mod.TenantQuota = admission_mod.TenantQuota()


@dataclasses.dataclass
class FrontendStats:
    """One consistent snapshot of the front end's request ledger.

    The conservation law the acceptance gate holds:
    ``submitted == completed + shed + timed_out + in_queue`` — every
    submitted request is accounted for at all times; a silent drop would
    break the balance (:meth:`ServeFrontend.assert_conserved`).
    """

    submitted: int
    admitted: int  # queued (exact + degraded-admission)
    shed: int
    completed: int
    timed_out: int
    degraded_responses: int  # of completed/timed_out: served degraded
    in_queue: int

    @property
    def balance(self) -> int:
        """``submitted - completed - shed - timed_out - in_queue`` (0 iff
        no request was ever lost track of)."""
        return (
            self.submitted - self.completed - self.shed - self.timed_out
            - self.in_queue
        )


class ServeFrontend:
    """Continuous-batching query front end over one ``dslsh.Index``.

    ``index`` is any ``repro_torch.dslsh`` handle — or an
    :class:`~repro_torch.runtime.elastic.ElasticIndex`, in which case every
    micro-batch rides the elastic failover path (chaos-tested: a
    mid-serve cell kill degrades-and-flags the affected batches, never
    silently). Time is injected everywhere (``now=``, default the
    monotonic clock), so tests and the chaos harness replay the exact
    same admission / timeout / scheduling decisions.

    Lifecycle: :meth:`submit` runs admission and queues;
    :meth:`pump` forms and executes one micro-batch (EDF order, §15
    scheduling); :meth:`drain` pumps until idle; :meth:`warmup` runs
    every (ladder rung x degradation level) shape up front, so every
    kernel library the path needs is built before the first request;
    :meth:`ingest` (streaming deployments)
    publishes new points via an RCU epoch swap.
    """

    def __init__(
        self,
        index,
        cfg: FrontendConfig | None = None,
        *,
        obs: obs_mod.Obs | None = None,
        clock_fn: Callable[[], float] = clock.monotonic,
    ):
        from repro_torch.core import pipeline

        self.cfg = cfg or FrontendConfig()
        self._clock = clock_fn
        self._obs_explicit = obs
        if isinstance(index, elastic_mod.ElasticIndex):
            self._elastic = index
            self._epoch = None  # the elastic wrapper owns epochs
            handle = index.index
        else:
            self._elastic = None
            self._epoch = elastic_mod.Epoch(0, index, None)
            handle = index
        pipeline._require(
            self.cfg.degrade is None or handle.plan is not None,
            "FrontendConfig.degrade maps deadline slack to a §10 max_cells"
            " cap — it needs a routed deployment (dslsh.grid(...,"
            " routed=True))",
        )
        self.coalescer = coalesce_mod.Coalescer(self.cfg.ladder)
        self.admission = admission_mod.AdmissionController(
            dict(self.cfg.quotas),
            default_quota=self.cfg.default_quota,
            max_queue=self.cfg.max_queue,
        )
        self._queue: list[ServeRequest] = []
        self._rid = itertools.count()
        self._completed = 0
        self._timed_out = 0
        self._degraded_responses = 0

    # ------------------------------------------------------------- facts

    @property
    def index(self):
        """The ``repro_torch.dslsh`` handle of the current serving epoch."""
        if self._elastic is not None:
            return self._elastic.index
        return self._epoch.index

    @property
    def epoch(self) -> elastic_mod.Epoch:
        """The current serving epoch (RCU snapshot — one reference read)."""
        if self._elastic is not None:
            return self._elastic.epoch
        return self._epoch

    @property
    def queue_depth(self) -> int:
        """Queued query rows (the admission backpressure signal)."""
        return sum(r.n_queries for r in self._queue)

    def stats(self) -> FrontendStats:
        """A consistent :class:`FrontendStats` snapshot right now."""
        a = self.admission.stats
        return FrontendStats(
            submitted=a.submitted,
            admitted=a.admitted + a.degraded,
            shed=a.shed,
            completed=self._completed,
            timed_out=self._timed_out,
            degraded_responses=self._degraded_responses,
            in_queue=len(self._queue),
        )

    def assert_conserved(self) -> FrontendStats:
        """Assert the request ledger balances (no silent drops) and
        return the snapshot it balanced on."""
        s = self.stats()
        assert s.balance == 0, s
        self.admission.stats.check()
        return s

    # ------------------------------------------------------------ submit

    def submit(
        self,
        queries,
        *,
        tenant: str = "default",
        deadline_s: float = math.inf,
        now: float | None = None,
    ) -> ServeRequest:
        """Admit one request -> a :class:`ServeRequest` ticket.

        The verdict is on the ticket: ``shed`` requests come back
        finalized immediately (explicit backpressure — the counters and
        ``dslsh_serve_shed_total`` record it); admitted requests are
        queued with their submission-stamped deadline and resolve on a
        later :meth:`pump`.
        """
        from repro_torch.core import pipeline

        t = self._clock() if now is None else now
        if isinstance(queries, torch.Tensor):
            queries = queries.cpu().numpy()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        pipeline._require(
            1 <= q.shape[0] <= self.coalescer.max_rows,
            f"request carries {q.shape[0]} queries; the micro-batch ladder"
            f" tops out at {self.coalescer.max_rows} — split the batch",
        )
        req = ServeRequest(
            rid=next(self._rid), tenant=tenant, queries=q,
            deadline_s=float(deadline_s), submitted_at=t,
        )
        with self._activate():
            req.verdict = self.admission.admit(
                tenant, req.n_queries, self.queue_depth, t
            )
        if req.verdict == admission_mod.Verdict.SHED:
            req.status = "shed"
            req.latency_s = 0.0
            return req
        req.status = "queued"
        self._queue.append(req)
        self._gauge_queue()
        return req

    # -------------------------------------------------------------- pump

    def pump(self, now: float | None = None) -> list[ServeRequest]:
        """Run one scheduling round: expire, coalesce, execute, finalize.

        Expires queued requests already past their deadline (finalized
        ``timed_out`` — counted, never silent), EDF-sorts the queue,
        forms one ladder-shaped micro-batch, picks its ``max_cells`` from
        the tightest slack in it (§15 scheduling), executes it on the
        current epoch, and scatters per-request result rows. Returns
        every request finalized this round (expired + served).
        """
        t = self._clock() if now is None else now
        done = self._expire(t)
        if not self._queue:
            self._gauge_queue()
            return done
        self._queue.sort(key=lambda r: r.deadline_at)
        mb = self.coalescer.form(self._queue)
        self._gauge_queue()
        cap = self._pick_cap(mb, t)
        with self._activate(), self._span(
            "serve.microbatch", rows=mb.n_real, bucket=mb.bucket,
            requests=len(mb.requests),
            max_cells=-1 if cap is None else cap,
        ):
            res, epoch_n, batch_lost = self._execute(mb, cap, t)
            kd = res.knn_dist.cpu().numpy()  # syncs the device work
            ki = res.knn_idx.cpu().numpy()
        t_done = self._clock() if now is None else t
        degraded = cap is not None or batch_lost
        for req, (lo, hi) in zip(mb.requests, mb.spans):
            req.knn_dist, req.knn_idx = kd[lo:hi], ki[lo:hi]
            req.max_cells, req.epoch = cap, epoch_n
            req.degraded = degraded
            self._finalize(req, t_done, timed_out=t_done > req.deadline_at)
            done.append(req)
        self._record_batch(mb, cap, t_done - t)
        return done

    def drain(self, now: float | None = None) -> list[ServeRequest]:
        """Pump until the queue is empty; returns everything finalized."""
        done: list[ServeRequest] = []
        while self._queue:
            done.extend(self.pump(now=now))
        return done

    def warmup(self, now: float | None = None) -> int:
        """Run every (ladder rung x degradation level) query shape with
        throwaway batches, outside the request accounting, so every kernel
        library the path needs is built. Returns the number of shapes
        run; after this, steady-state serving leaves
        ``obs.query_retraces()`` flat (tests/test_torch_frontend.py).
        """
        index = self.index
        d = self._dim(index)
        mid = 0.5 * (index.cfg.val_lo + index.cfg.val_hi)
        caps: list[int | None] = [None]
        if self.cfg.degrade is not None:
            for _, c in self.cfg.degrade:
                if c not in caps:
                    caps.append(c)
        n = 0
        for rung in self.coalescer.ladder:
            q = np.full((rung, d), mid, np.float32)
            for cap in caps:
                res = index.query(q, max_cells=cap)
                res.knn_dist.cpu()
                n += 1
        return n

    # ------------------------------------------------------------ ingest

    def ingest(self, xs, ts: float = 0.0, now: float | None = None):
        """Publish new points with one RCU epoch swap (streaming only).

        Builds the next streaming state *aside* — ``Index.snapshot()``
        clones the per-node state list while sharing every tensor —
        ingests into the clone (including
        any pressure-triggered compaction), then publishes it as the next
        :class:`~repro_torch.runtime.elastic.Epoch` with a single reference
        assignment. A micro-batch that snapshotted the previous epoch
        keeps serving the old state bit-exactly; it can never observe a
        half-applied compaction. Returns the
        :class:`~repro_torch.stream.shard.IngestReport`.
        """
        from repro_torch.core import pipeline

        pipeline._require(
            self._elastic is None,
            "elastic-wrapped front ends serve batch grids; streaming"
            " ingest rides a plain streaming-deployment handle",
        )
        epoch = self._epoch
        pipeline._require(
            epoch.index.deploy.kind == "streaming",
            "ingest needs a streaming deployment"
            " (dslsh.streaming(...)) — batch deployments are immutable",
        )
        nxt = epoch.index.snapshot()
        with self._activate(), self._span("serve.ingest_swap", ts=float(ts)):
            rep = nxt.ingest(xs, ts)
            self._epoch = elastic_mod.advance(epoch, nxt)
        ob = self._obs()
        if ob is not None and ob.metrics is not None:
            ob.metrics.counter(
                "dslsh_serve_ingest_swaps_total",
                "RCU epoch swaps published by streaming ingest (§15)",
            ).inc()
            ob.metrics.gauge(
                "dslsh_serve_epoch", "current front-end serving epoch"
            ).set(float(self._epoch.n))
        return rep

    # ---------------------------------------------------------- internal

    def _execute(self, mb: coalesce_mod.MicroBatch, cap, t):
        """Run one micro-batch on the current epoch -> (result, epoch_n,
        lost-cells flag)."""
        if self._elastic is not None:
            er = self._elastic.query(mb.queries, now=t, max_cells=cap)
            return er.result, er.epoch, er.degraded
        epoch = self._epoch  # RCU read: ingest swaps never tear a batch
        res = epoch.index.query(mb.queries, max_cells=cap)
        return res, epoch.n, False

    def _pick_cap(self, mb: coalesce_mod.MicroBatch, t: float) -> int | None:
        """The batch's §10 ``max_cells`` cap: tightest-slack degradation
        level, further tightened to the worst level when an
        admission-DEGRADE request rides the batch."""
        levels = self.cfg.degrade
        if levels is None:
            return None
        cap = routing.degrade_max_cells(mb.deadline_at - t, levels)
        if any(
            r.verdict == admission_mod.Verdict.DEGRADE for r in mb.requests
        ):
            worst = levels[-1][1]
            if cap is None:
                cap = worst
            elif worst is not None:
                cap = min(cap, worst)
        return cap

    def _expire(self, t: float) -> list[ServeRequest]:
        """Finalize queued requests whose deadline already passed
        (timed out in queue — flagged, counted, no compute spent)."""
        if not self._queue:
            return []
        live, dead = [], []
        for r in self._queue:
            (dead if r.deadline_at <= t else live).append(r)
        self._queue = live
        for r in dead:
            self._finalize(r, t, timed_out=True)
        return dead

    def _finalize(
        self, req: ServeRequest, t: float, *, timed_out: bool
    ) -> None:
        req.status = "timed_out" if timed_out else "done"
        req.latency_s = max(t - req.submitted_at, 0.0)
        if timed_out:
            self._timed_out += 1
        else:
            self._completed += 1
        if req.degraded:
            self._degraded_responses += 1
        ob = self._obs()
        if ob is None or ob.metrics is None:
            return
        m = ob.metrics
        m.histogram(
            "dslsh_serve_frontend_latency_seconds",
            "submit -> finalize latency per request (queued time counts)",
        ).labels(outcome=req.status).observe(req.latency_s)
        if timed_out:
            m.counter(
                "dslsh_serve_frontend_timeouts_total",
                "requests finalized past their submission-relative"
                " deadline — flagged, never silent",
            ).inc()
        else:
            m.counter(
                "dslsh_serve_goodput_total",
                "requests completed within their deadline",
            ).inc()
        if req.degraded:
            m.counter(
                "dslsh_serve_degraded_responses_total",
                "responses served under a §10 max_cells cap or with lost"
                " cells (flagged on the ticket)",
            ).inc()

    def _record_batch(
        self, mb: coalesce_mod.MicroBatch, cap, dur_s: float
    ) -> None:
        ob = self._obs()
        if ob is None or ob.metrics is None:
            return
        m = ob.metrics
        m.histogram(
            "dslsh_serve_microbatch_rows",
            "real query rows per coalesced micro-batch",
            buckets=obs_mod.metrics.COUNT_BUCKETS,
        ).observe(float(mb.n_real))
        m.counter(
            "dslsh_serve_queries_served_total",
            "real query rows executed (the sustained-QPS numerator)",
        ).inc(float(mb.n_real))
        m.counter(
            "dslsh_serve_pad_rows_total",
            "ladder padding rows computed and discarded",
        ).inc(float(mb.padding))
        m.histogram(
            "dslsh_serve_microbatch_latency_seconds",
            "pump wall time per micro-batch (coalesce -> synced result)",
        ).observe(dur_s)

    def _gauge_queue(self) -> None:
        ob = self._obs()
        if ob is not None and ob.metrics is not None:
            ob.metrics.gauge(
                "dslsh_serve_queue_depth",
                "queued query rows awaiting a micro-batch",
            ).set(float(self.queue_depth))

    def _obs(self):
        ob = self._obs_explicit
        if ob is None:
            ob = obs_mod.get_active()
        return ob if (ob is not None and ob.enabled) else None

    def _activate(self):
        ob = self._obs_explicit
        if ob is not None and ob.enabled:
            return ob.activate()
        import contextlib

        return contextlib.nullcontext()

    def _span(self, name: str, **args):
        ob = self._obs()
        if ob is None:
            return obs_mod.NULL_SPAN
        return ob.span(name, **args)

    @staticmethod
    def _dim(index) -> int:
        """Feature dimension of the served index (any deployment)."""
        if index.deploy.kind == "streaming":
            return int(index._state["core"].state[0].store.shape[1])
        return int(index._state["data"].shape[1])


class AsyncFrontend:
    """Asyncio face of :class:`ServeFrontend`: awaitable submits with a
    background pump loop, and ingest interleaving between micro-batches.

    Admission and queueing are fully asynchronous; each micro-batch's
    compute runs synchronously inside the loop (one query call), so
    concurrency is between *requests* — many tenants await while one
    ladder-shaped batch executes — not within a batch. ``await
    submit(...)`` resolves to the finalized :class:`ServeRequest`
    (including shed/timed-out tickets: backpressure is an answer too)::

        af = AsyncFrontend(ServeFrontend(index))

        async def main():
            async with af:
                req = await af.submit(q, tenant="icu-3", deadline_s=0.05)
            return req.status
    """

    def __init__(self, frontend: ServeFrontend):
        self.frontend = frontend
        self._task = None
        self._wake = None

    async def __aenter__(self) -> "AsyncFrontend":
        """Start the pump loop task."""
        import asyncio

        self._wake = asyncio.Event()
        self._task = asyncio.create_task(self._pump_loop())
        return self

    async def __aexit__(self, *exc) -> None:
        """Drain the queue and stop the pump loop."""
        self.frontend.drain()
        self._resolve(self.frontend.pump())  # flush expiries
        if self._task is not None:
            self._task.cancel()
            import asyncio

            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def submit(self, queries, **kw) -> ServeRequest:
        """Admit one request and await its finalized ticket."""
        import asyncio

        self._futures: dict = getattr(self, "_futures", {})
        req = self.frontend.submit(queries, **kw)
        if req.status == "shed":
            return req
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._futures[req.rid] = fut
        self._wake.set()
        return await fut

    async def ingest(self, xs, ts: float = 0.0):
        """RCU-ingest between micro-batches (streaming deployments)."""
        import asyncio

        rep = self.frontend.ingest(xs, ts)
        await asyncio.sleep(0)  # yield so queued submits interleave
        return rep

    async def _pump_loop(self) -> None:
        import asyncio

        while True:
            if not self.frontend._queue:
                self._wake.clear()
                await self._wake.wait()
            self._resolve(self.frontend.pump())
            await asyncio.sleep(0)

    def _resolve(self, done: list[ServeRequest]) -> None:
        futures = getattr(self, "_futures", {})
        for req in done:
            fut = futures.pop(req.rid, None)
            if fut is not None and not fut.done():
                fut.set_result(req)
