"""ingest_roofline (kernels): the bytes the traced ingest calls need at
the card's peak bandwidth, over the device time of the kernels launched
inside them (interval union, from the profiler trace).  Needed bytes:
each entry an append or a merge reads once and writes once, 12 B an
entry, counted from the program's counters and the shapes
(``arith.merge_traffic``), never from which implementation ran."""
from port_bench import arith


def read(run):
    if run.trace is None or not run.peaks:
        return None
    calls = [c for c in run.calls if "merge" in c]
    t = run.trace.device_s("bench.ingest")
    if not calls or t <= 0:
        return None
    appended = sum(c["merge"][0] for c in calls)
    moved = sum(c["merge"][1] + c["merge"][2] for c in calls)
    nbytes = arith.ENTRY_BYTES * (2 * appended + moved)
    return 100.0 * nbytes / run.peaks["bytes_per_s"] / t
