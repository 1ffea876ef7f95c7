"""query_tail_roofline.batch: the least time for kernel D's work in the traced
slice (bench/roofline.py: counted from the inputs and the comparisons)
over D's profiled device time, in percent."""
from bench import trace


def read(run):
    prof = run.record.get("profile")
    bound = run.record.get("tail_bound_s")
    if prof is None or bound is None:
        return None
    seconds, calls = trace.kernel_seconds(prof, "query_tail_kernel")
    if calls == 0 or seconds <= 0:
        return None
    return 100.0 * bound / seconds
