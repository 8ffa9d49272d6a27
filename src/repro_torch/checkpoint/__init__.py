"""Checkpoints of the port (``CheckpointManager``)."""
from repro_torch.checkpoint.manager import CheckpointInfo, CheckpointManager  # noqa: F401
