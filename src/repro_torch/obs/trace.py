"""Span tracer: nested timing spans exported as Chrome trace-event JSON.

:class:`Tracer` records :class:`Span` context managers into a flat
complete-event list (``"ph": "X"``) that Perfetto / ``chrome://tracing``
load directly. Nesting needs no parent pointers: complete events on the
same track nest by time containment, and the per-thread span stack is a
``contextvars.ContextVar`` so concurrently traced threads (or asyncio
tasks) each get their own depth chain (DESIGN.md §12).

Timestamps come from :func:`repro_torch.obs.clock.monotonic` relative to the
tracer's creation, converted to the microseconds the trace-event format
specifies. The disabled path is a single shared no-op span
(:data:`NULL_SPAN`): entering it allocates nothing and reads no clock.
"""
from __future__ import annotations

import contextvars
import json
import threading

from repro_torch.obs import clock


class Span:
    """One in-flight timing span (a ``with tracer.span(...)`` body).

    ``dur_s`` is populated on exit; ``args`` are the key=value attributes
    attached at open (they land in the trace event's ``args`` field).
    """

    __slots__ = ("tracer", "name", "args", "t0", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.dur_s = 0.0

    def __enter__(self) -> "Span":
        self.tracer._stack.set(self.tracer._stack.get() + 1)
        self.t0 = clock.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = clock.monotonic()
        self.dur_s = t1 - self.t0
        self.tracer._stack.set(self.tracer._stack.get() - 1)
        tr = self.tracer
        tr.events.append(
            {
                "name": self.name,
                "ph": "X",
                "ts": (self.t0 - tr._origin) * 1e6,
                "dur": self.dur_s * 1e6,
                "pid": tr.pid,
                "tid": threading.get_ident() & 0x7FFFFFFF,
                "args": self.args,
            }
        )
        return False


class _NullSpan:
    """Shared no-op span: the disabled tracing path. Reads no clock."""

    __slots__ = ()
    dur_s = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()
"""The singleton no-op span every disabled ``span(...)`` call returns."""


class Tracer:
    """Collects nested :class:`Span` events; exports Chrome trace JSON.

    >>> tr = Tracer()
    >>> with tr.span("outer"):
    ...     with tr.span("inner", stage="hash"):
    ...         pass
    >>> [e["name"] for e in tr.events]
    ['inner', 'outer']
    """

    def __init__(self, pid: int = 0):
        self.pid = pid
        self.events: list[dict] = []
        self._origin = clock.monotonic()
        self._stack: contextvars.ContextVar[int] = contextvars.ContextVar(
            "obs_span_depth", default=0
        )

    def span(self, name: str, **args) -> Span:
        """Open a span context manager named ``name`` with attributes
        ``args`` (must be JSON-serializable; they ride into the event)."""
        return Span(self, name, args)

    def depth(self) -> int:
        """Current span nesting depth in this thread/task (0 = top)."""
        return self._stack.get()

    def clear(self) -> None:
        """Drop recorded events and re-anchor the time origin."""
        self.events.clear()
        self._origin = clock.monotonic()

    def to_chrome_trace(self) -> dict:
        """The Perfetto-loadable trace document (trace-event format)."""
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
        }

    def save(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path``; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
        return path
