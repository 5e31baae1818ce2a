"""sort_live_pct (merge route): the share of the slots the sort route
sorted in the traced ingest calls that held an entry (``live``, the
non-sentinel input slots, over ``width``, summed over the same
``assoc.merge`` spans as ``sorted_slots_per_update``)."""
from port_bench import spans


def read(run):
    merges = spans.sort_merges(run)
    if not merges:
        return None
    width = sum(r["attrs"]["width"] for r in merges)
    return 100.0 * sum(r["attrs"]["live"] for r in merges) / width
