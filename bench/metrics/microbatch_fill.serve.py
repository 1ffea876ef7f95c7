"""microbatch_fill.serve: real rows over real and padding rows of the
window's micro-batches, from the front end's counters
``dslsh_serve_queries_served_total`` and ``dslsh_serve_pad_rows_total``."""


def read(run):
    real, pad = run.record.get("served_rows"), run.record.get("pad_rows")
    if not real:
        return None
    return 100.0 * real / (real + pad)
