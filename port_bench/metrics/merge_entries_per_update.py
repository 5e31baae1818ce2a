"""merge_entries_per_update (hierarchy): entries the window's merges read
and wrote, per update ingested.  A merge at depth d reads the block, layer
0's slots and layers 1..d, and writes its unique result into layer d,
counted from the per-step ``spills`` and ``nnz0`` telemetry and the
layers' ``nnz`` around each call (``arith.merge_traffic``: a lower bound
where a layer is merged into twice in one call).  Read in traced runs."""


def read(run):
    calls = [c for c in run.calls if "merge" in c]
    if not calls:
        return None
    entries = sum(c["merge"][1] + c["merge"][2] for c in calls)
    return entries / sum(c["updates"] for c in calls)
