"""Runtime layers of the port: fault tolerance, the proxy server, the
model zoo's train and serve steps and telemetry."""
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    FaultTolerantRunner,
    RunnerConfig,
    StepMonitor,
)
from repro_torch.runtime.proxy_server import (  # noqa: F401
    PERCENTILES,
    REQUEST_CLASSES,
    LatencyRecorder,
    ProxyServer,
    ServerClosed,
    percentile,
)
from repro_torch.runtime.serve_loop import (  # noqa: F401
    make_decode_step,
    make_prefill_step,
    pad_caches,
)
from repro_torch.runtime.train_loop import (  # noqa: F401
    TrainSettings,
    TrainState,
    init_train_state,
    make_train_step,
    train_state_meta,
)
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
