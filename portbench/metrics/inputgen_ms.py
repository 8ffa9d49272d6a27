"""inputgen_ms: device ms of every node's input generation, captured and
replayed alone with the run's seeds."""


def read(run):
    return None if run.trace is None else run.trace.inputgen_ms
