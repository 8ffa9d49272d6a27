"""setup_kernels_s: seconds of set-up in the ``kernels.load`` span, the
hand-written kernels' library loaded (built on a checkout's first run);
nothing where no kernel launched (``spans.setup_parts``)."""
from portbench.spans import read_setup


def read(run):
    return read_setup(run, "kernels")
