"""The data motifs of the port's first slice — sort, matrix and
statistics, the three K-means needs — as parameterized PyTorch modules."""
from repro_torch.core.motifs.base import (  # noqa: F401
    MOTIFS,
    SUBSTRATES,
    TUNABLE_BOUNDS,
    Motif,
    PVector,
    get_motif,
    lowered_motifs,
)

# importing the modules populates the registry
from repro_torch.core.motifs import matrix, sort, statistics  # noqa: F401

# ... and this one the substrate-lowering registry (substrate="hopper")
from repro_torch.core.motifs import kernel_lowerings  # noqa: F401  (isort: skip)
