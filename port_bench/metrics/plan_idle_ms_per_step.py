"""plan_idle_ms_per_step (hierarchy): device idle that began while the
host was inside ``stream.plan`` (the step's depth plan and its
``.tolist()``, which drains the queue) in the traced ingest calls, in ms
per fleet block-step (``spans.idle_by_span``)."""
from port_bench import spans


def read(run):
    idle = spans.idle_by_span(run)
    if idle is None or not spans.steps(run):
        return None
    return 1e3 * idle.get(spans.PLAN, 0.0) / spans.steps(run)
