"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their plain
PyTorch versions (``ref``).  Nothing is compiled at import."""
