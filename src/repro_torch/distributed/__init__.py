"""Logical-axis sharding for the port (``repro_torch.distributed.
sharding``): so far only the rule table the mesh-shape arithmetic of
``repro_torch.core.cluster`` reads."""
