"""launches_per_query.batch: device operations (kernels, copies, sets) in
the traced slice of ``Index.query`` calls, per query (device trace)."""


def read(run):
    prof = run.record.get("profile")
    if prof is None or not run.record.get("profile_queries"):
        return None
    return prof["n_ops"] / run.record["profile_queries"]
