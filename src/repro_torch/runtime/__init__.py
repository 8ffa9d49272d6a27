"""Runtime layers of the port.  Only telemetry so far; the proxy server
(``repro/runtime/proxy_server.py``) is not ported yet."""
from repro_torch.runtime.telemetry import (  # noqa: F401
    EVENT_KINDS,
    METRIC_KINDS,
    NULL,
    SPAN_KINDS,
    TRACE_VERSION,
    NullTelemetry,
    Telemetry,
    get_default,
    set_default,
)
