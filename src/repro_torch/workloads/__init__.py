"""The paper's workloads ported so far: K-means."""
from repro_torch.workloads.base import WORKLOADS, Workload  # noqa: F401
from repro_torch.workloads import kmeans  # noqa: F401  (registers itself)
