"""The paper's five real workloads (BigDataBench 4.0 selection, §III-A)."""
from repro_torch.workloads.base import WORKLOADS, Workload  # noqa: F401

# importing registers the five workloads
from repro_torch.workloads import (  # noqa: F401
    alexnet,
    inception_v3,
    kmeans,
    pagerank,
    terasort,
)
