"""The port's kernels against the JAX package's Pallas kernels.

The same numpy inputs go through ``repro.kernels.ops`` (Pallas in
interpret mode, as ``tests/test_kernels.py`` runs them on the CPU) and
through ``repro_torch.kernels.ops``, whose wrappers run the plain
versions for CPU tensors.  The CUDA kernels themselves are compared with
the plain versions by ``test_torch_cuda.py``.

Tolerances: f32 matrix products and row sums summed in another order,
``rtol=1e-4, atol=1e-4`` (products) and ``rtol=1e-4, atol=1e-5`` (means
of O(1) values); bf16 products round one f32 result to bf16, which may
flip by an ulp, ``rtol=1e-2, atol=1e-2``; sorts are exact.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_np, np_rand, to_jax, to_torch

from repro.kernels import bitonic_sort as jbs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import bitonic_sort as tbs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

MATMUL_SHAPES = [(128, 128, 128), (300, 200, 150), (64, 512, 32),
                 (129, 65, 257)]
MATMUL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
              "bfloat16": dict(rtol=1e-2, atol=1e-2)}
SORT_CASES = [(1024, 256), (5000, 512), (100, 64), (4096, 4096)]
SORT_DTYPES = ["uint32", "int32", "float32"]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(m, k, n, dtype):
    x, y = np_rand(1, (m, k), "float32"), np_rand(2, (k, n), "float32")
    want = jops.matmul(to_jax(x, dtype), to_jax(y, dtype), interpret=True)
    got = tops.matmul(to_torch(x, dtype), to_torch(y, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), **MATMUL_TOL[dtype])


@pytest.mark.parametrize("rows,d", [(8, 128), (33, 512), (256, 1024),
                                    (8, 70_000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_moments_matches_pallas(rows, d, dtype):
    x = np_rand(3, (rows, d), "float32")
    wm, wq = jops.row_moments(to_jax(x, dtype), interpret=True)
    gm, gq = tops.row_moments(to_torch(x, dtype))
    assert gm.dtype == gq.dtype == torch.float32
    np.testing.assert_allclose(as_np(gm), as_np(wm), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(as_np(gq), as_np(wq), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,block", SORT_CASES)
@pytest.mark.parametrize("dtype", SORT_DTYPES)
def test_sort_matches_reference(n, block, dtype):
    """``ops.sort`` (bitonic runs + rank merges) against the reference's
    plain sort on the same keys."""
    x = np_rand(5, (n,), dtype)
    got = tops.sort(to_torch(x), block=block)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(as_np(got), as_np(jref.sort(to_jax(x))))


@pytest.mark.parametrize("n,block", [(100, 64), (1024, 256)])
def test_sort_matches_pallas(n, block):
    """... and against the Pallas composition itself (interpret mode is
    slow, so two of the cases above)."""
    x = np_rand(5, (n,), "uint32")
    want = jops.sort(to_jax(x), block=block, interpret=True)
    np.testing.assert_array_equal(as_np(tops.sort(to_torch(x), block=block)),
                                  as_np(want))


def _sorted_blocks(x: np.ndarray, block: int, sentinel) -> np.ndarray:
    pad = np.full((-x.shape[0]) % block, sentinel, x.dtype)
    return np.sort(np.concatenate([x, pad]).reshape(-1, block), -1).ravel()


@pytest.mark.parametrize("n,block", SORT_CASES + [(10, 1024), (5000, 8192)])
@pytest.mark.parametrize("dtype", ["uint32", "float32"])
def test_bitonic_sort_blocks_output(n, block, dtype):
    """The raw kernel output: sorted runs at the clamped block, padded
    with the reference's sentinel."""
    x = np_rand(6, (n,), dtype)
    blk = jbs.effective_block(n, block)
    want = _sorted_blocks(x, blk, as_np(jbs.sort_sentinel(x.dtype)).item())
    got = tbs.bitonic_sort_blocks(to_torch(x), block=block)
    np.testing.assert_array_equal(as_np(got), want)


def test_bitonic_sort_blocks_matches_pallas():
    x = np_rand(6, (100,), "float32")
    want = jbs.bitonic_sort_blocks(to_jax(x), block=64, interpret=True)
    got = tbs.bitonic_sort_blocks(to_torch(x), block=64)
    np.testing.assert_array_equal(as_np(got), as_np(want))


@pytest.mark.parametrize("n,block", [(10, 1024), (5000, 8192)])
def test_sort_block_larger_than_n_regression(n, block):
    """Merging must use the clamped run length, not the requested block
    (the reference's regression in ``tests/test_kernels.py``)."""
    x = np_rand(99, (n,), "uint32")
    got = tops.sort(to_torch(x), block=block)
    np.testing.assert_array_equal(as_np(got), np.sort(x))


@pytest.mark.parametrize("n", [1, 3, 10, 100, 4096, 5000])
@pytest.mark.parametrize("block", [2, 16, 512, 1024, 8192])
def test_effective_block_equals_reference(n, block):
    assert tbs.effective_block(n, block) == jbs.effective_block(n, block)


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32", "bfloat16"])
def test_sort_sentinel_equals_reference(dtype):
    got = tbs.sort_sentinel(getattr(torch, dtype))
    want = jbs.sort_sentinel(getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert as_np(got).item() == as_np(want).item()


def _emulate_network(x: np.ndarray, block: int, tile: int) -> np.ndarray:
    """numpy replay of the CUDA kernel's passes (``bitonic_schedule``):
    the same pair indices and direction rule as ``csrc/bitonic_sort.cu``."""
    n = x.shape[0]
    n_pad = n + (-n) % block
    buf = np.concatenate([x, np.full(n_pad - n, tbs.sort_sentinel(
        torch.from_numpy(x[:1]).dtype).item(), x.dtype)])
    lt = int(math.log2(tile))

    def substep(k, j, idx):  # idx: global lower indices of the pairs
        d = 1 << j
        asc = (((idx & (block - 1)) >> k) & 1) == 0
        a, b = buf[idx], buf[idx + d]
        swap = np.where(asc, b < a, a < b)
        buf[idx] = np.where(swap, b, a)
        buf[idx + d] = np.where(swap, a, b)

    def pairs(j, length):
        p = np.arange(length // 2)
        return ((p >> j) << (j + 1)) | (p & ((1 << j) - 1))

    for kind, a, b in tbs.bitonic_schedule(block, tile):
        if kind == "global":
            substep(a, b, pairs(b, n_pad))
            continue
        for k in range(a, b + 1):
            for j in range(min(k, lt) - 1, -1, -1):
                substep(k, j, pairs(j, n_pad))  # every tile's pairs at once
    return buf


@pytest.mark.parametrize("n,block,tile", [
    (1000, 256, 256),        # one shared-memory pass per block
    (5000, 4096, 64),        # global passes for strides >= the tile
    (70_001, 1 << 15, tbs.TILE),  # the kernel's own tile, ragged input
])
@pytest.mark.parametrize("dtype", ["uint32", "float32"])
def test_bitonic_schedule_sorts_like_the_plain_version(n, block, tile, dtype):
    """The pass order the CUDA wrapper launches sorts every block."""
    x = np_rand(7, (n,), dtype)
    got = _emulate_network(x, block, tile)
    want = tref.sort_blocks(to_torch(x), block,
                            tbs.sort_sentinel(getattr(torch, dtype)).item())
    np.testing.assert_array_equal(got, as_np(want))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.randn(8, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tops.matmul(x, torch.randn(3, 4).T)
    with pytest.raises(TypeError):
        tops.matmul(x, torch.randn(4, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tops.row_moments(torch.randn(4, 8).T)
    with pytest.raises(TypeError):
        tops.bitonic_sort_blocks(torch.arange(8, dtype=torch.int64), block=4)
    with pytest.raises(ValueError):
        torch.ops.repro_torch.bitonic_sort_blocks(torch.randn(8), 3)


def test_plain_path_launches_nothing():
    tops.reset_launches()
    tops.matmul(torch.randn(8, 4), torch.randn(4, 3))
    tops.row_moments(torch.randn(4, 8))
    tops.sort(torch.randn(100), block=16)
    assert tops.launch_counts() == {"matmul": 0, "row_moments": 0,
                                    "bitonic_sort": 0}
