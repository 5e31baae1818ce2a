"""setup_s: from the process's start to the first timed call: imports,
the CUDA context, the kernels' build where it is stale, the streams and
keys made from the seed, the warm-up calls and the query's capture."""


def read(run):
    return run.setup_s
