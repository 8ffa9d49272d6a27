"""The benchmark's own arithmetic against hand-worked shapes."""
import json
from pathlib import Path

import pytest
import torch

from portbench import counts, devtrace, reference
from portbench.reference.arith import tf32_round

HERE = Path(__file__).resolve().parent


def test_matmul_rows_1_and_1b():
    # row 1: (8192,2048)@(2048,128) f32, 2*8192*128*2048 / 67e12 s
    w = counts.matmul(8192, 2048, 128)
    assert w.ops == 2 * 8192 * 128 * 2048
    assert w.nbytes == (8192 * 2048 + 2048 * 128 + 8192 * 128) * 4
    assert w.bound_by() == "operations"
    assert w.bound_s() * 1e3 == pytest.approx(0.0641, abs=5e-5)
    # row 1b: (32,2048)@(2048,2048), bound by its 17.3 MB at 3.35 TB/s
    w = counts.matmul(32, 2048, 2048)
    assert w.bound_by() == "bytes"
    assert w.bound_s() * 1e3 == pytest.approx(0.0052, abs=5e-5)


def test_row_moments_rows_2_and_2b():
    w = counts.row_moments(1024, 57)
    assert w.nbytes == 1024 * 57 * 4 + 2 * 1024 * 4
    assert w.bound_by() == "bytes"
    assert w.bound_s() * 1e3 == pytest.approx(0.0001, abs=5e-5)
    assert counts.row_moments(16, 8192).bound_s() * 1e3 == pytest.approx(
        0.0002, abs=5e-5)


def test_sort_blocks_counts_the_functions_work():
    w = counts.sort_blocks(39321, 2048)
    assert w.ops == 39321 * 11
    assert w.nbytes == (39321 + 20 * 2048) * 4


@pytest.mark.parametrize("op,shapes,mnk", [
    ("aten::mm", [[8192, 2048], [2048, 128]], (8192, 2048, 128)),
    ("repro_torch::matmul", [[32, 2048], [2048, 2048]], (32, 2048, 2048)),
    ("aten::addmm", [[128], [64, 32], [32, 128]], (64, 32, 128)),
])
def test_product_work_reads_the_operands(op, shapes, mnk):
    assert devtrace.product_work(op, shapes) == counts.matmul(*mnk)


def test_product_work_of_a_batched_product():
    assert devtrace.product_work("aten::bmm", [[4, 8, 16], [4, 16, 32]]) \
        == counts.bmm(4, 8, 16, 32)
    assert counts.bmm(4, 8, 16, 32).ops == 4 * counts.matmul(8, 16, 32).ops


def test_kmeans_flops_by_hand():
    # matrix/euclidean, weight 1.5 -> 2 runs: 8192 of 12288 rows of 2048
    # (4 tasks x 1 x 2048), 128 centroids; statistics/average weight 0.9 -> 1
    # run over 57 rows (1 task x 1 x 57) of 1024; sort: no arithmetic
    proxy = json.loads((HERE / "configs" / "kmeans.json").read_text())["proxy"]
    used, k, d = 8192, 128, 2048
    euclid = 2 * used * k * d + 2 * (used + k) * d + 3 * used * k
    average = 3 * 57 * 1024
    assert reference.flops(proxy) == 2 * euclid + average
    assert reference.products(proxy) == 2


def test_ai_motif_flops_by_hand():
    # conv2d weight 1.8 -> 2 runs of 8x32x32x64 -> 64, 3x3; the dense layer
    # (32,2048)@(2048,2048) + bias once; max pooling none; batch norm over
    # 8x32x32x16 elements, 6 each, weight 0.8 -> 1
    base = {"data_size": 65536, "chunk_size": 4096, "num_tasks": 2,
            "batch_size": 8, "height": 32, "width": 32, "channels": 16}
    nodes = [("transform", "conv2d", dict(base, data_size=235928,
                                         num_tasks=4, weight=1.8,
                                         channels=64)),
             ("matrix", "fully_connected", dict(base, weight=1.0)),
             ("sampling", "maxpool", dict(base, data_size=104856,
                                         chunk_size=2048, num_tasks=4,
                                         weight=0.4, height=64)),
             ("statistics", "batchnorm", dict(base, data_size=52428,
                                             chunk_size=2048, num_tasks=4,
                                             weight=0.8))]
    proxy = {"nodes": [{"id": f"n{i}", "motif": m, "variant": v, "deps": [],
                        "p": p} for i, (m, v, p) in enumerate(nodes)]}
    conv = 2 * 8 * 32 * 32 * 64 * 64 * 9
    dense = 2 * 32 * 2048 * 2048 + 32 * 2048
    assert reference.flops(proxy) == 2 * conv + dense + 6 * 8 * 32 * 32 * 16
    assert reference.products(proxy) == 1


def test_tf32_round_keeps_ten_mantissa_bits():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 3 * 2 ** -12, one + 2 ** -10,
                      -(one + 3 * 2 ** -12), 0.0, 3.0])
    want = torch.tensor([one, one + 2 ** -10, one + 2 ** -10,
                         -(one + 2 ** -10), 0.0, 3.0])
    assert torch.equal(tf32_round(x), want)
