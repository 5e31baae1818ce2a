"""query_copy_gb_per_batch (engine): the bytes the captured
``service.point_query`` copied into its static inputs at replay (each
dispatch span's ``copied_bytes``: the state leaves that changed since the
last replay), in GB per batch answered in the traced window."""
from port_bench import spans


def read(run):
    sess = spans.session(run)
    if sess is None or not run.batches:
        return None
    copied = sum(r["attrs"].get("copied_bytes", 0) for r in sess["spans"]
                 if r["name"] == spans.QUERY)
    return copied / 1e9 / len(run.batches)
