"""PyTorch/CUDA port of the data-motif proxy-benchmark generator.

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module (``data/``, ``core/motifs/``, ``kernels/``,
``core/``, ``workloads/``) and never imports it or ``jax``.  Plain tensor
code is PyTorch; the three kernels the ``generate_proxy`` paths reach
(tiled matmul, row moments, bitonic sort), like the other three of
``kernels.ops``, are CUDA C++ written for Hopper (``kernels/csrc``),
built with ``nvcc`` at first use.

Every entry point takes ``device=``; ``None`` means CUDA, and a host
without a CUDA device must ask for ``device="cpu"`` explicitly
(:func:`repro_torch.device.resolve_device`).
"""
from repro_torch.device import resolve_device  # noqa: F401
