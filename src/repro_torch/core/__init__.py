"""The paper's contribution — data motifs -> proxy benchmark generation —
ported to PyTorch.  Exports the reference's names as far as they are
ported (not the cluster layer, ``PopulationRegistry`` or the HLO parser)."""
from repro_torch.core.accuracy import (  # noqa: F401
    COLLECTIVE_METRICS,
    AccuracyReport,
    compare,
    deviations,
    eq3_accuracy,
    normalized_vector,
)
from repro_torch.core.decompose import (  # noqa: F401
    COLLECTIVE_TO_MOTIF,
    MotifHint,
    collective_shares,
    decompose,
    hlo_shares,
)
from repro_torch.core.evaluator import (  # noqa: F401
    BatchEvaluator,
    EvalSession,
    ExecutableCache,
    serial_evaluate_batch,
)
from repro_torch.core.generator import (  # noqa: F401
    ProxyReport,
    generate_proxy,
    proxy_metrics,
    proxy_signature,
)
from repro_torch.core.motifs import MOTIFS, Motif, PVector, get_motif  # noqa: F401
from repro_torch.core.priors import (  # noqa: F401
    EMPTY_PRIORS,
    PRIOR_FAMILIES,
    PRIOR_FIELDS,
    PriorTable,
    elasticity_priors,
    seed_num_tasks,
)
from repro_torch.core.proxy_graph import (  # noqa: F401
    MotifNode,
    ProxyBenchmark,
    linear_chain,
)
from repro_torch.core.signature import (  # noqa: F401
    Signature,
    measure_wall_time,
    profile_call,
    signature_of_call,
    timed_wall,
)
from repro_torch.core.store import (  # noqa: F401
    STORE_VERSION,
    ProxyStore,
    atomic_write_text,
    device_key,
)
from repro_torch.core.tuner import DecisionTree, DecisionTreeTuner, TuneResult  # noqa: F401
