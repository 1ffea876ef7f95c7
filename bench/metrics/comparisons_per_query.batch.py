"""comparisons_per_query.batch: ``DistributedQueryResult.comparisons``
summed over the cells, per query, over the window's calls (the paper's
count of distinct candidates compared)."""


def read(run):
    if not run.record.get("queries"):
        return None
    return run.record["comparisons"] / run.record["queries"]
