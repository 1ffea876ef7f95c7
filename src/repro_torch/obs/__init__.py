"""Observability of the port: tracing, metrics and exporters (DESIGN.md §12).

A copy of ``repro.obs`` (pure Python). One object — :class:`Obs` — bundles
a :class:`~repro_torch.obs.trace.Tracer` and a
:class:`~repro_torch.obs.metrics.MetricsRegistry`: pass it to
``dslsh.build(..., obs=...)``, ``Index.with_obs`` or
:class:`~repro_torch.stream.monitor.StreamingMonitor`, or activate it
ambiently with ``with obs.activate(): ...`` so nested calls (the per-stage
query schedule, streaming ingest) record into it without plumbing.

The disabled path does one attribute check plus one ``ContextVar.get`` and
branches away: no clock read, no allocation, no device sync.

Sync points: a span over work on the CUDA card measures only the host's
enqueue unless it synchronizes. As in the JAX package, the per-stage
``query.*`` and ``build.*`` spans (recorded only while tracing) and the
streaming ingest span synchronize the device before they close; the other
spans do not.

Quick start::

    from repro_torch import dslsh, obs

    ob = obs.Obs()
    idx = dslsh.build(0, data, cfg, dslsh.single(), obs=ob)
    idx.query(q)                      # spans + metrics recorded
    ob.save_trace("trace.json")       # open in https://ui.perfetto.dev
    print(ob.prometheus())            # scrape-format metrics
"""
from __future__ import annotations

import contextlib
import contextvars

from repro_torch.obs import clock, metrics, trace
from repro_torch.obs.clock import monotonic, wall  # noqa: F401  (re-export)
from repro_torch.obs.metrics import (  # noqa: F401  (re-export)
    GLOBAL,
    LATENCY_BUCKETS,
    MetricsRegistry,
    count_retrace,
    log_buckets,
    retrace_count,
)
from repro_torch.obs.trace import NULL_SPAN, Tracer  # noqa: F401  (re-export)

_ACTIVE: contextvars.ContextVar["Obs | None"] = contextvars.ContextVar(
    "obs_active", default=None
)


def get_active() -> "Obs | None":
    """The ambiently activated :class:`Obs` (or None). Instrumented call
    sites consult this when no obs was bound explicitly — one cheap
    ``ContextVar.get`` on the disabled path."""
    return _ACTIVE.get()


class Obs:
    """A tracing + metrics bundle, enabled or disabled per facet.

    ``Obs()`` is fully enabled; ``Obs(trace=False)`` records metrics
    only; ``Obs.disabled()`` is the instrumented-but-disabled handle the
    overhead gate times (every recording site sees ``enabled`` False and
    branches away immediately).
    """

    __slots__ = ("name", "tracer", "metrics")

    def __init__(
        self, name: str = "dslsh", *, trace: bool = True, metrics: bool = True
    ):
        self.name = name
        self.tracer = Tracer() if trace else None
        self.metrics = MetricsRegistry() if metrics else None

    @classmethod
    def disabled(cls) -> "Obs":
        """An instrumented-but-disabled bundle: every site checks and
        skips. This is the configuration the ``obs_overhead`` CI gate
        (≤ 1.05 vs bare) and the 5%-overhead test pin."""
        return cls(trace=False, metrics=False)

    @property
    def enabled(self) -> bool:
        """True when either facet (tracing or metrics) records."""
        return self.tracer is not None or self.metrics is not None

    @property
    def tracing(self) -> bool:
        """True when spans record (controls the §12 sync-point policy)."""
        return self.tracer is not None

    def span(self, name: str, **args):
        """A span context manager on the tracer — or the shared no-op
        span when tracing is off (no clock read, no allocation)."""
        if self.tracer is None:
            return NULL_SPAN
        return self.tracer.span(name, **args)

    @contextlib.contextmanager
    def activate(self):
        """Make this bundle the ambient :func:`get_active` target for the
        duration of the ``with`` block (re-entrant; nesting restores the
        previous bundle on exit)."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def timed_section(self, label: str) -> "timed_section":
        """A :class:`timed_section` bound to this bundle."""
        return timed_section(label, obs=self)

    # ------------------------------------------------------------ export

    def snapshot(self) -> dict:
        """Merged JSON metrics snapshot: this bundle's registry plus the
        process-global one (the compile counts live there)."""
        out = dict(metrics.GLOBAL.snapshot())
        if self.metrics is not None:
            out.update(self.metrics.snapshot())
        return out

    def prometheus(self) -> str:
        """Merged Prometheus text exposition (own registry + global)."""
        text = metrics.GLOBAL.prometheus_text()
        if self.metrics is not None:
            text += self.metrics.prometheus_text()
        return text

    def save_trace(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path`` (Perfetto-loadable).
        Raises if tracing is off (there is nothing to save)."""
        if self.tracer is None:
            raise ValueError("tracing is disabled on this Obs bundle")
        return self.tracer.save(path)

    def save_metrics(self, path: str) -> str:
        """Write the merged JSON snapshot to ``path``; returns ``path``."""
        import json

        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path


class timed_section:
    """Timed block replacing hand-rolled ``t0 = time.time()`` timing.

    Measures on the monotonic clock, exposes a live ``elapsed_s`` for
    in-loop progress lines, and — when an obs bundle is bound or active —
    records a span plus a ``dslsh_section_seconds{section=...}``
    histogram observation on exit::

        with obs.timed_section("train.steps") as sec:
            ...
            print(f"({sec.elapsed_s:.1f}s)")
    """

    __slots__ = ("label", "obs", "t0", "dur_s", "_span")

    def __init__(self, label: str, *, obs: "Obs | None" = None):
        self.label = label
        self.obs = obs
        self.t0 = 0.0
        self.dur_s = 0.0
        self._span = None

    @property
    def elapsed_s(self) -> float:
        """Seconds since the block was entered (live, monotonic)."""
        return clock.monotonic() - self.t0

    def __enter__(self) -> "timed_section":
        ob = self.obs if self.obs is not None else _ACTIVE.get()
        self.obs = ob
        if ob is not None and ob.tracer is not None:
            self._span = ob.tracer.span(self.label)
            self._span.__enter__()
        self.t0 = clock.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_s = clock.monotonic() - self.t0
        if self._span is not None:
            self._span.__exit__(*exc)
            self._span = None
        ob = self.obs
        if ob is not None and ob.metrics is not None:
            ob.metrics.histogram(
                "dslsh_section_seconds",
                "wall time of labeled operational sections",
            ).labels(section=self.label).observe(self.dur_s)
        return False


def retraces(stage: str) -> int:
    """Public retrace counter for ``stage``: in the port, the kernel
    library builds of ``kernels/_build.py`` and the streaming core's
    program constructions (:func:`metrics.count_retrace`)."""
    return metrics.retrace_count(stage)


#: Every stage of the query path the port's counter can count: the kernel
#: libraries a query may build, and the streaming core's query program.
QUERY_STAGES: tuple[str, ...] = (
    "stream_query",
    "hash_pack",
    "l1_topk",
    "query_fused",
    "query_payload",
)


def query_retraces() -> int:
    """Total retraces across every query-path stage (:data:`QUERY_STAGES`):
    after a warm-up, serving any batch leaves it unchanged."""
    return sum(metrics.retrace_count(s) for s in QUERY_STAGES)
