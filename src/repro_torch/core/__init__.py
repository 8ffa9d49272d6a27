"""The paper's contribution — data motifs -> proxy benchmark generation —
ported to PyTorch.  Submodules are imported where used."""
