"""proxy_mfu: the arithmetic of one proxy run, from the benchmark's own
count per node (``reference.flops``: motif, variant, P and repeats), over
proxy_ms at the card's float32 peak, in %."""


def read(run):
    if run.flops_per_run <= 0:
        return None
    rate = run.flops_per_run / (run.proxy_ms * 1e-3)
    return 100.0 * rate / run.peaks["float32_flops_per_s"]
