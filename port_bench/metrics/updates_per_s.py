"""updates_per_s: every update acknowledged in the window (its ingest
call returned and was synchronized) over the whole window, the fleet's
resets and the query batches answered between calls included."""


def read(run):
    if not run.calls:
        return None
    return run.updates / run.window_s
