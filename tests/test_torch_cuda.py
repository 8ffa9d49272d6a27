"""The port's CUDA kernels against their plain PyTorch versions.

These need a CUDA device and skip without one.  The module imports no
JAX, so it also runs on a GPU host that has none:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py

Tolerances as in ``test_torch_kernels.py``: f32 products
``rtol=1e-4, atol=1e-4``, bf16 products ``rtol=1e-2, atol=1e-2``, row
moments ``rtol=1e-4, atol=1e-5``; sorts are exact.
"""
import pytest
import torch

from torch_parity import cuda_device, np_rand, to_torch  # noqa: F401

from repro_torch.kernels import bitonic_sort as tbs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

MATMUL_SHAPES = [(128, 128, 128), (300, 200, 150), (64, 512, 32),
                 (129, 65, 257)]
MATMUL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
              "bfloat16": dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_matmul_matches_plain(cuda_device, dtype):
    for m, k, n in MATMUL_SHAPES:
        x = to_torch(np_rand(1, (m, k), "float32"), dtype).to(cuda_device)
        y = to_torch(np_rand(2, (k, n), "float32"), dtype).to(cuda_device)
        torch.testing.assert_close(tops.matmul(x, y).float(),
                                   tref.matmul(x, y).float(),
                                   **MATMUL_TOL[dtype])


@pytest.mark.cuda
def test_cuda_row_moments_matches_plain(cuda_device):
    x = to_torch(np_rand(3, (8, 70_000), "float32")).to(cuda_device)
    for got, want in zip(tops.row_moments(x), tref.row_moments(x)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32", "bfloat16"])
def test_cuda_bitonic_sort_matches_plain(cuda_device, dtype):
    for n, block in [(5000, 4096), (70_001, 1 << 15)]:
        x = to_torch(np_rand(4, (n,), "float32" if dtype == "bfloat16"
                             else dtype), dtype).to(cuda_device)
        want = tref.sort_blocks(x, block, tbs.sort_sentinel(x.dtype).item())
        assert torch.equal(tbs.bitonic_sort_blocks(x, block=block), want)


@pytest.mark.cuda
def test_cuda_wrappers_count_one_launch_per_call(cuda_device):
    x = torch.randn(64, 32, device=cuda_device)
    tops.reset_launches()
    tops.matmul(x, x.T.contiguous())
    tops.row_moments(x)
    tops.sort(x.reshape(-1), block=256)
    assert tops.launch_counts() == {"matmul": 1, "row_moments": 1,
                                    "bitonic_sort": 1}
