"""inputs_ms: device ms a proxy run of the kernels launched while one of
the runner's ``proxy.inputs`` spans was open, over the profiled eager
runs (``spans.RunSpans``)."""
from portbench.spans import read_phase


def read(run):
    return read_phase(run, "proxy.inputs")
