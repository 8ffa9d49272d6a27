"""launches_per_run: device kernels in the traced back-to-back runs, over
the number of runs traced."""


def read(run):
    tr = run.trace
    if tr is None or tr.kernels == 0:
        return None
    return tr.kernels / tr.replays
