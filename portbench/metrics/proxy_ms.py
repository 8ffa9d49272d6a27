"""proxy_ms: the window's length over the proxy runs completed in it."""


def read(run):
    return run.proxy_ms
