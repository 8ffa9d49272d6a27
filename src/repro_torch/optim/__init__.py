"""The port's optimiser (port of ``repro.optim``): AdamW on tensor trees,
LR schedules and gradient compression."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init_meta,
    adamw_update,
    global_norm,
    clip_by_global_norm,
)
from repro_torch.optim.schedules import warmup_cosine, warmup_linear  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    CompressionState,
    compress_topk_init,
    ef_topk_compress_decompress,
    int8_compress,
    int8_decompress,
)
