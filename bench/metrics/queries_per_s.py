"""queries_per_s: every window answered over all the time of the whole
calls in the window (host clock, each call synced)."""


def read(run):
    calls = run.record.get("calls")
    if not calls:
        return None
    return sum(n for n, _ in calls) / sum(s for _, s in calls)
