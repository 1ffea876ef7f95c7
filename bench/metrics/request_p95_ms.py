"""request_p95_ms: the nearest-rank 95th percentile over every request of
the window, from when it was due to when its rows came back; a shed
request reads FAILED_MS."""
import math

from bench.harness import percentile

FAILED_MS = 1e9


def read(run):
    lat = run.record.get("latency_s")
    if not lat:
        return None
    return percentile([FAILED_MS if math.isinf(x) else 1e3 * x for x in lat], 95)
