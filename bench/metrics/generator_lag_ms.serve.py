"""generator_lag_ms.serve: the nearest-rank 95th percentile over the
window's requests of how late the open loop submitted each, after its due
time (host clock). The loop submits between pumps, so a request due during
a pump waits for it; its latency counts from when it was due either way."""
from bench.harness import percentile


def read(run):
    lag = run.record.get("lag_s")
    if not lag:
        return None
    return 1e3 * percentile(lag, 95)
