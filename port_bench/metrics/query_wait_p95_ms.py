"""query_wait_p95_ms (service loop): the 95th percentile of the time a
batch waited from when it was due to its dispatch, behind the ingest call
and the batches before it."""
from port_bench import arith


def read(run):
    wait = [b["dispatch"] - b["due"] for b in run.batches
            if b["due"] < run.seconds]
    if not wait:
        return None
    return 1e3 * arith.percentile(wait, 95)
