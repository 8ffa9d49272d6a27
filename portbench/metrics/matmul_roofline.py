"""matmul_roofline: the matrix products' least time, from the benchmark's
own count at each call's shapes (``counts.matmul``), over the device time
of those calls' kernels, in %.  Read from profiled eager runs; the same
work is counted whichever operator runs it (the hand-written kernel's or
ATen's)."""
from portbench.devtrace import product_work


def read(run):
    tr = run.trace
    if tr is None:
        return None
    calls = [(product_work(op, shapes).bound_s(), us * 1e-6)
             for op, shapes, us in tr.products]
    device_s = sum(d for _, d in calls)
    if device_s <= 0:
        return None
    return 100.0 * sum(b for b, _ in calls) / device_s
