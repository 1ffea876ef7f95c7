"""predict_ms.stream: the median, over the window's ticks, of the synced
predict time the monitor reports (``StreamEvent.latency_s``)."""
import statistics


def read(run):
    ticks = run.record.get("ticks")
    if not ticks:
        return None
    return 1e3 * statistics.median(t[1] for t in ticks)
