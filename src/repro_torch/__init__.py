"""PyTorch/CUDA port of the data-motif proxy-benchmark generator.

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module (``data/``, ``core/motifs/``, ``kernels/``,
``core/``, ``workloads/``) and never imports it or ``jax``.  Plain tensor
code is PyTorch; the three kernels on the ``generate_proxy``-on-K-means
path (tiled matmul, row moments, bitonic sort) are CUDA C++ written for
Hopper (``kernels/csrc``), built with ``nvcc`` at first use.

Every entry point takes ``device=``; ``None`` means CUDA, and a host
without a CUDA device must ask for ``device="cpu"`` explicitly
(:func:`repro_torch.device.resolve_device`).
"""
from repro_torch.device import resolve_device  # noqa: F401
