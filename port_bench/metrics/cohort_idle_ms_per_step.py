"""cohort_idle_ms_per_step (hierarchy): device idle that began while the
host was dispatching a step's cohorts (``stream.append``, each
``stream.member`` and its ``assoc.merge``) in the traced ingest calls, in
ms per fleet block-step (``spans.idle_by_span``)."""
from port_bench import spans


def read(run):
    idle = spans.idle_by_span(run)
    if idle is None or not spans.steps(run):
        return None
    return 1e3 * sum(idle.get(n, 0.0) for n in spans.COHORT) \
        / spans.steps(run)
