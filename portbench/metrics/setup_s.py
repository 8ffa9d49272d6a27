"""setup_s: process start to the first timed run: imports, loading (or on
a checkout's first run, building) the kernels, the warm-up runs and the
graph's capture."""


def read(run):
    return run.setup_s
