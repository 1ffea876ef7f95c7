"""Process-local metrics registry: counters, gauges, histograms — no deps.

A copy of ``repro.obs.metrics`` (pure Python), with the same family names,
help strings and exposition formats; only the meaning of the retrace
counter is the port's own (see :func:`count_retrace`).

:class:`MetricsRegistry` holds named metric families; a family fans out
to labeled children (``fam.labels(stage="hash").inc()``). Exports are
the two formats operators actually consume (DESIGN.md §12):

* :meth:`MetricsRegistry.prometheus_text` — Prometheus text exposition
  (``# TYPE`` headers, cumulative ``_bucket{le=...}`` histogram lines),
  scrape-ready;
* :meth:`MetricsRegistry.snapshot` — a plain JSON-serializable dict for
  artifacts and tests.

Histograms use fixed log-spaced buckets (:func:`log_buckets`): latency
spans decades, so linear buckets waste resolution where it matters.

:data:`GLOBAL` is the process-global registry for signals that are
process facts rather than per-handle facts — the compile counts
(:func:`count_retrace` / :func:`retrace_count`).
"""
from __future__ import annotations

import bisect
import json
import math
import threading

_LOCK = threading.Lock()


def log_buckets(
    lo: float = 1e-6, hi: float = 10.0, per_decade: int = 4
) -> tuple[float, ...]:
    """Log-spaced histogram boundaries from ``lo`` to at least ``hi``.

    Boundaries are ``lo * 10**(i / per_decade)`` for ``i = 0..N`` with
    ``N`` the smallest count reaching ``hi`` — strictly increasing, and
    always covering ``[lo, hi]`` (an implicit +Inf bucket catches the
    rest). The default spans 1 µs .. 10 s at 4 buckets per decade: the
    repo's query latencies live well inside it.
    """
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(
            f"log_buckets needs 0 < lo < hi and per_decade >= 1, got"
            f" lo={lo} hi={hi} per_decade={per_decade}"
        )
    n = math.ceil(per_decade * math.log10(hi / lo))
    # 4 significant digits keep the ``le=`` labels readable; the
    # neighbour ratio 10**(1/per_decade) dwarfs the <= 5e-4 relative
    # rounding error for any sane per_decade, so boundaries stay
    # strictly increasing (the property test pins this)
    return tuple(
        float(f"{lo * 10 ** (i / per_decade):.4g}") for i in range(n + 1)
    )


LATENCY_BUCKETS = log_buckets()
"""Default latency boundaries (seconds): 1 µs .. 10 s, 4 per decade."""

COUNT_BUCKETS = log_buckets(1.0, 1e6, per_decade=2)
"""Default count boundaries (e.g. comparisons per query): 1 .. 1e6."""


def _label_key(labels: dict) -> str:
    """Canonical ``k="v"`` label string (sorted; '' for no labels)."""
    return ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))


class Counter:
    """A monotonically increasing value (one labeled child)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0)."""
        self.value += n


class Gauge:
    """A value that goes up and down (one labeled child)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        """Set the gauge to ``v``."""
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (may be negative)."""
        self.value += n


class Histogram:
    """Fixed-boundary histogram (one labeled child).

    ``counts[i]`` is the number of observations ``v <= boundaries[i]``
    (first matching bucket, non-cumulative in storage); ``counts[-1]``
    is the +Inf bucket. Exposition emits the Prometheus cumulative form.
    """

    __slots__ = ("boundaries", "counts", "sum", "count")

    def __init__(self, boundaries: tuple[float, ...]):
        self.boundaries = boundaries
        self.counts = [0] * (len(boundaries) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        """Record one observation ``v``."""
        self.counts[bisect.bisect_left(self.boundaries, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> list[int]:
        """Cumulative counts per ``le`` boundary, +Inf last (the
        Prometheus ``_bucket`` series)."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the ``q``-quantile from bucket counts
        — the ``histogram_quantile`` read (benchmarks report p50/p99
        latency through it). Returns the smallest boundary whose
        cumulative count covers ``q * count``; observations in the +Inf
        bucket clamp to the largest finite boundary; NaN when empty."""
        if self.count == 0 or not self.boundaries:
            return float("nan")
        target = q * self.count
        acc = 0
        for b, c in zip(self.boundaries, self.counts):
            acc += c
            if acc >= target:
                return b
        return self.boundaries[-1]


class Family:
    """One named metric family: kind + help text + labeled children."""

    def __init__(self, name: str, kind: str, help: str, buckets=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = buckets
        self.children: dict[str, Counter | Gauge | Histogram] = {}

    def labels(self, **labels):
        """The child for this label set (created on first use)."""
        key = _label_key(labels)
        child = self.children.get(key)
        if child is None:
            with _LOCK:
                child = self.children.get(key)
                if child is None:
                    if self.kind == "counter":
                        child = Counter()
                    elif self.kind == "gauge":
                        child = Gauge()
                    else:
                        child = Histogram(self.buckets)
                    self.children[key] = child
        return child

    # conveniences for the no-label common case
    def inc(self, n: float = 1.0) -> None:
        """``labels().inc(n)`` — the unlabeled child."""
        self.labels().inc(n)

    def set(self, v: float) -> None:
        """``labels().set(v)`` — the unlabeled child (gauges)."""
        self.labels().set(v)

    def observe(self, v: float) -> None:
        """``labels().observe(v)`` — the unlabeled child (histograms)."""
        self.labels().observe(v)


class MetricsRegistry:
    """A process-local set of metric families.

    >>> reg = MetricsRegistry()
    >>> reg.counter("dslsh_queries_total").labels(deployment="single").inc()
    >>> reg.snapshot()["dslsh_queries_total"]["values"]
    {'deployment="single"': 1.0}
    """

    def __init__(self):
        self._families: dict[str, Family] = {}

    def _family(self, name, kind, help, buckets=None) -> Family:
        fam = self._families.get(name)
        if fam is None:
            with _LOCK:
                fam = self._families.get(name)
                if fam is None:
                    fam = Family(name, kind, help, buckets)
                    self._families[name] = fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind},"
                f" requested {kind}"
            )
        return fam

    def counter(self, name: str, help: str = "") -> Family:
        """The counter family ``name`` (registered on first use)."""
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> Family:
        """The gauge family ``name`` (registered on first use)."""
        return self._family(name, "gauge", help)

    def histogram(
        self, name: str, help: str = "", buckets: tuple[float, ...] | None = None
    ) -> Family:
        """The histogram family ``name``; ``buckets`` (default
        :data:`LATENCY_BUCKETS`) binds on first registration."""
        return self._family(
            name, "histogram", help, buckets or LATENCY_BUCKETS
        )

    # ------------------------------------------------------------ export

    def snapshot(self) -> dict:
        """JSON-serializable dump: ``{name: {type, help, values}}`` where
        histogram values carry ``{buckets: {le: cumulative}, sum, count}``."""
        out = {}
        for name, fam in sorted(self._families.items()):
            values = {}
            for key, child in sorted(fam.children.items()):
                if fam.kind == "histogram":
                    cum = child.cumulative()
                    les = [_fmt(b) for b in fam.buckets] + ["+Inf"]
                    values[key] = {
                        "buckets": dict(zip(les, cum)),
                        "sum": child.sum,
                        "count": child.count,
                    }
                else:
                    values[key] = child.value
            out[name] = {"type": fam.kind, "help": fam.help, "values": values}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition of every family (scrape format)."""
        lines = []
        for name, fam in sorted(self._families.items()):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in sorted(fam.children.items()):
                if fam.kind == "histogram":
                    cum = child.cumulative()
                    for b, c in zip(fam.buckets, cum):
                        lines.append(
                            f"{name}_bucket{{{_merge(key, le=_fmt(b))}}} {c}"
                        )
                    lines.append(
                        f'{name}_bucket{{{_merge(key, le="+Inf")}}} {cum[-1]}'
                    )
                    lines.append(f"{name}_sum{_braced(key)} {_fmt(child.sum)}")
                    lines.append(f"{name}_count{_braced(key)} {child.count}")
                else:
                    lines.append(f"{name}{_braced(key)} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def save_json(self, path: str) -> str:
        """Write :meth:`snapshot` as JSON to ``path``; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path

    def clear(self) -> None:
        """Drop every family (tests use this to isolate counts)."""
        with _LOCK:
            self._families.clear()


def _fmt(v: float) -> str:
    """Shortest clean number form (ints without trailing .0)."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _braced(key: str) -> str:
    return f"{{{key}}}" if key else ""


def _merge(key: str, **extra) -> str:
    merged = ",".join(f'{k}="{v}"' for k, v in extra.items())
    return f"{key},{merged}" if key else merged


# --------------------------------------------------------- process globals

GLOBAL = MetricsRegistry()
"""Process-global registry: compile counts and other process facts."""

_RETRACES = GLOBAL.counter(
    "dslsh_jit_retraces_total",
    "jit (re)traces per pipeline stage — steady state adds none"
    " (DESIGN.md §4/§12)",
)


def count_retrace(stage: str) -> None:
    """Bump the public retrace counter for ``stage``.

    The port traces nothing, so the counter counts what stands in for a
    trace: a compile. ``kernels/_build.py``, the port's only compile step,
    calls it once for each kernel library it builds (stage = the library's
    name, e.g. ``"query_fused"``), and the streaming core (``ShardedStream``) once for each
    insert and query program it makes (``"stream_insert"``,
    ``"stream_query"``; an RCU clone shares its source's programs and adds
    none). Steady-state dispatch never touches it."""
    _RETRACES.labels(stage=stage).inc()


def retrace_count(stage: str) -> int:
    """Total (re)traces recorded for ``stage`` in this process (see
    :func:`count_retrace`)."""
    return int(_RETRACES.labels(stage=stage).value)
