"""query_p95_ms: the 95th percentile, over every batch due in the
window, of the time from when the batch was due (open loop) or issued
(closed loop) to its answer on the host."""
from port_bench import arith


def read(run):
    lat = [b["answer"] - b["due"] for b in run.batches
           if b["due"] < run.seconds]
    if not lat:
        return None
    return 1e3 * arith.percentile(lat, 95)
