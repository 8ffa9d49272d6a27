"""setup_graph_s: seconds of set-up in the ``graph.setup`` span, the
warm-ups and capture of the proxy's CUDA graph, less the ``kernels.load``
inside it (``spans.setup_parts``)."""
from portbench.spans import read_setup


def read(run):
    return read_setup(run, "graph")
