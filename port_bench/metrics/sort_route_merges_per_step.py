"""sort_route_merges_per_step (merge route): canonicalizations that took
the sort route (``registry.LAUNCHES["assoc.sort_route"]``) inside the
window's ingest calls, per fleet block-step."""


def read(run):
    if not run.calls:
        return None
    steps = sum(c["blocks"] for c in run.calls)
    return sum(c["sort_route"] for c in run.calls) / steps
