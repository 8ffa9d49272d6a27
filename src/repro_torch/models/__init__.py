"""The port's model zoo: configs in ``repro_torch.configs``, metadata trees
and init in ``params``, attention in ``flash``, blocks in ``layers``,
``mamba2`` and ``rglru``, the stack in ``trunk``, the encoder-decoder in
``whisper`` and the public API in ``model_zoo``."""
from repro_torch.models.model_zoo import (  # noqa: F401
    EncDecModel,
    Model,
    build_model,
    cross_entropy,
    input_specs,
    make_inputs,
)
from repro_torch.models.params import (  # noqa: F401
    ParamMeta,
    abstract_params,
    count_params,
    init_params,
    meta,
)
