"""event_p90_ms: the nearest-rank 90th percentile, over every tick of the
window, of the synced wall time of ``StreamingMonitor.step`` (predict and
ingest, compactions included)."""
from bench.harness import percentile


def read(run):
    ticks = run.record.get("ticks")
    if not ticks:
        return None
    return 1e3 * percentile([t[0] for t in ticks], 90)
