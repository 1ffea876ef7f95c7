"""Observability of the port. Only the clock is ported so far; the tracer
and the metrics registry of ``repro.obs`` wait (see ROADMAP.md)."""
