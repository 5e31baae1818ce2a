"""host_reads_per_step (hierarchy): the program's device-to-host reads
(``obs.trace.host_reads``, every site) over the traced session, per fleet
block-step of the traced calls."""
from port_bench import spans


def read(run):
    sess = spans.session(run)
    if sess is None or not spans.steps(run):
        return None
    at = sess["host_reads"]
    reads = sum(at["disable"].values()) - sum(at["enable"].values())
    return reads / spans.steps(run)
