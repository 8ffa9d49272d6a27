"""The plain reference against the port on tiny proxies, on the CPU.

Every variant of every motif the reference covers, as the second node of
a chain (so its inputs are perturbed by the first node's outputs) with a
weight that repeats it, on both substrates (the hopper lowerings run the
kernels' plain versions here).  Integer outputs must match exactly; the
port computes floats in float32 and the reference in float64."""
import json

import pytest
import torch

from portbench import check, reference
from portbench.reference import gen
from repro_torch.core.motifs import base
from repro_torch.core.proxy_graph import (MotifNode, ProxyBenchmark,
                                          _forward_intermediate)

CPU = torch.device("cpu")
VARIANTS = [(m, v) for m in ("matrix", "statistics", "sort", "sampling",
                             "transform")
            for v in reference.motif(m).VARIANTS]
P = base.PVector(data_size=3000, chunk_size=64, num_tasks=3, weight=2.4,
                 batch_size=5, height=8, width=6, channels=3)
SPECS = {"uniform": dict(sparsity=0.3), "normal": dict(dist_scale=1.5),
         "zipf": dict(zipf_alpha=1.1)}


def chain(motif, variant, substrate, distribution, layout="NHWC"):
    p = P.replace(distribution=distribution, substrate=substrate,
                  layout=layout, **SPECS[distribution])
    return ProxyBenchmark("t", (
        MotifNode("a", "matrix", "euclidean", p),
        MotifNode("b", motif, variant, p, deps=("a",))))


def numbers(pb, seed):
    got = pb.build_fn(CPU)(seed)
    ref, choices = reference.run(json.loads(pb.to_json()), seed, CPU)
    return check.compare(got, ref, choices)


@pytest.mark.parametrize("substrate", ["torch", "hopper"])
@pytest.mark.parametrize("motif,variant", VARIANTS)
def test_reference_matches_the_port(motif, variant, substrate):
    for distribution in SPECS:
        got = numbers(chain(motif, variant, substrate, distribution),
                      2 ** 31 + 5)
        assert got["exact_mismatch"] == 0, (distribution, got)
        assert got["rel_err"] <= 1e-5, (distribution, got)


@pytest.mark.parametrize("motif,variant", [
    ("statistics", "batchnorm"), ("sampling", "maxpool"),
    ("sampling", "dropout"), ("transform", "conv2d_strided")])
def test_reference_matches_the_port_on_nchw(motif, variant):
    got = numbers(chain(motif, variant, "torch", "uniform", "NCHW"), 3)
    assert got["exact_mismatch"] == 0 and got["rel_err"] <= 1e-5


def test_derive_seed_is_the_programs():
    from repro_torch.data.generators import derive_seed

    for parts in [(0, 0), (2 ** 31 + 7, 3), (123456789012, 0)]:
        assert gen.derive_seed(*parts) == derive_seed(*parts)


def leaves():
    g = torch.Generator().manual_seed(1)
    return {"f": torch.rand(5, generator=g),
            "i32": torch.arange(4, dtype=torch.int32),
            "u32": gen.u32_from_i64(torch.tensor([0, 1, 2 ** 32 - 1, 7])),
            "i64": torch.arange(3, dtype=torch.int64),
            "b": torch.tensor([True, False])}


def bitwise(a, b):
    return a.dtype == b.dtype and torch.equal(check._bits(a), check._bits(b))


def test_checksum_and_perturb_are_the_programs():
    tree = leaves()
    assert torch.equal(reference.checksum(tree), base._tree_checksum(tree))
    for eps in (torch.tensor(0.0), torch.tensor(3e-12)):
        mine, theirs = reference.perturb(tree, eps), base._tree_perturb(tree,
                                                                        eps)
        assert all(bitwise(mine[k], theirs[k]) for k in tree)


def test_forward_is_the_programs():
    tree = leaves()
    up = [{"f": torch.ones(5), "i32": torch.zeros(3, dtype=torch.int32)},
          {"f": torch.zeros(5), "b": torch.tensor([False, False])}]
    mine = reference.forward(tree, up)
    _, theirs = _forward_intermediate(tree, up)
    assert set(mine) == set(theirs)
    assert all(bitwise(mine[k], theirs[k]) for k in tree)
    assert torch.equal(mine["f"], torch.ones(5))  # the first upstream's
    assert torch.equal(mine["i32"], tree["i32"])  # another shape: kept
