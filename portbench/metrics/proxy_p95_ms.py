"""proxy_p95_ms: the 95th percentile (nearest rank) of the window's runs,
each timed on the device between the CUDA events around it."""
import math


def read(run):
    times = sorted(run.run_ms)
    return times[math.ceil(0.95 * len(times)) - 1]
