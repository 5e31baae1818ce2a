"""sorted_slots_per_update (merge route): the slots the sort route sorted
in the traced ingest calls (the ``width`` of each sort-route
``assoc.merge`` span under a ``stream.ingest_instances`` dispatch), per
update ingested."""
from port_bench import spans


def read(run):
    merges = spans.sort_merges(run)
    updates = sum(c["updates"] for c in run.calls)
    if merges is None or not updates:
        return None
    return sum(r["attrs"]["width"] for r in merges) / updates
