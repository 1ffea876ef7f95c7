"""pump_ms.serve: the median synced wall time of a ``pump`` that ran a
micro-batch, over the window (host clock)."""
import statistics


def read(run):
    pumps = run.record.get("pump_s")
    if not pumps:
        return None
    return 1e3 * statistics.median(pumps)
