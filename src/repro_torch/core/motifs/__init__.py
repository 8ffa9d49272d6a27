"""The eight data motifs (paper §II-A) as parameterized PyTorch modules
(port of ``repro/core/motifs/__init__.py``)."""
from repro_torch.core.motifs.base import (  # noqa: F401
    MOTIFS,
    SUBSTRATES,
    TUNABLE_BOUNDS,
    Motif,
    PVector,
    get_motif,
    lowered_motifs,
    motif_names,
)

# importing the modules populates the registry
from repro_torch.core.motifs import (  # noqa: F401
    graph,
    logic,
    matrix,
    sampling,
    set_ops,
    sort,
    statistics,
    transform,
)

# ... and this one the substrate-lowering registry (substrate="hopper")
from repro_torch.core.motifs import kernel_lowerings  # noqa: F401  (isort: skip)
