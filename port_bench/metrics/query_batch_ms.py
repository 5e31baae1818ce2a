"""The median time from a batch's dispatch to its answer on the host:
the staged ``service.point_query`` (a CUDA-graph replay, with the copy of
a changed state into the graph's inputs) and the answer's read."""
from port_bench import arith


def read(run):
    ms = [b["answer"] - b["dispatch"] for b in run.batches]
    if not ms:
        return None
    return 1e3 * arith.percentile(ms, 50)
