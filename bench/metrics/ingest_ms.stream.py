"""ingest_ms.stream: the median, over the window's ticks, of the tick's
synced wall time less its predict time (the ingest, with any compaction)."""
import statistics


def read(run):
    ticks = run.record.get("ticks")
    if not ticks:
        return None
    return 1e3 * statistics.median(t[0] - t[1] for t in ticks)
