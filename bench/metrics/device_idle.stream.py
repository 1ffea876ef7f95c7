"""The share of the traced slice's window in which no device operation ran
(device trace), in percent."""
from bench import trace


def read(run):
    return trace.idle_percent(run.record.get("profile"))
