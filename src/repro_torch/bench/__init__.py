"""Drivers of the port's benchmarks (ports of ``benchmarks/*``).

Run each as a module from the repo root, e.g.
``PYTHONPATH=src python -m repro_torch.bench.kernels_bench --check``."""
