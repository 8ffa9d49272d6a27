"""Input data of the port (port of ``repro.data``): the generators, and
the training pipeline (``pipeline``)."""
from repro_torch.data.pipeline import DataPipeline, synthetic_lm_batch  # noqa: F401
